"""queries_per_s: answers completed in the window over the window's seconds
(host clock; the window ends when the last step begun before the close has
answered)."""


def read(rec):
    return len(rec.requests) / rec.window_s if rec.window_s > 0 else None
