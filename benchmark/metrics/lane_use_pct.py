"""Lanes fed over lanes run (%): a feed runs every slot of the session,
fed or not; counted by the harness over the window."""


def read(run):
    run_lanes = run.counts.get("lanes_run")
    return 100.0 * run.counts["lanes_fed"] / run_lanes if run_lanes else None
