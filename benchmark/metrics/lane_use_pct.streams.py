"""Lanes fed over lanes run (%), counted by the program: the session's
``lanes_fed`` and ``lanes_run`` (padding lanes included), over the window.
A session without those counters, or a window that ran no lane, reads
nothing."""


def install(run):
    session = run.program
    if hasattr(session, "lanes_fed") and hasattr(session, "lanes_run"):
        run.scratch["lanes_at_start"] = (session.lanes_fed,
                                         session.lanes_run)


def read(run):
    start = run.scratch.get("lanes_at_start")
    if start is None or run.program is None:
        return None
    fed = run.program.lanes_fed - start[0]
    ran = run.program.lanes_run - start[1]
    return 100.0 * fed / ran if ran > 0 else None
