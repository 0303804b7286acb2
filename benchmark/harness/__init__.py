"""The benchmark's harness: finding a cell's files, making its weights and
inputs, timing its window, reading its trace, and judging its outputs."""
