"""The share of the traced window with no kernel, copy or set on the
card (a union of intervals), the mean over the cards, in %."""


def read(record):
    share = record.get("idle_share")
    return None if share is None else 100.0 * share
