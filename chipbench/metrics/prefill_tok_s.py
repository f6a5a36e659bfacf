"""Prompt tokens completed a second: every token of every step of the
window over the window's whole time (host clock)."""


def read(run):
    return run.steps * run.tokens_per_step / run.window_s
