"""Real events done in the window over the window's seconds: in training,
events whose step completed (first measured step to the sync after the
last); in inference, events whose outputs reached the host.  Every
``<kind>_events_per_s`` metric reads this: the names differ so that each
cell kind keeps a bound of its own."""


def read(r):
    if not r.window_s:
        return None
    return r.events / r.window_s
