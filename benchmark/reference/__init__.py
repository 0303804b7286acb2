"""Plain fp32 references that decide whether a run's outputs are correct.
They import nothing of the program."""
