"""Seconds of the graph's build on the card in set-up: the harness's timer
around ``prepare_generated_graph``, fenced by a synchronise at its end."""


def read(run):
    return run.timers.get("graph_build_s")
