"""learn.kept_item_share: the share of the learn step kernel's items
whose gradient it takes from the evaluations its potential pass kept
(the program's counter ``learn.kept_items``) among all it launched
(``learn.items``), both counted by the host a launch from the tables,
over the run's process, in percent. A program without the counters
(one older than the kept form) gives None, as does a run off the card
(a traced slice with no device intervals), as the span readers do."""

from gibbsbench import spans


def read(run: dict):
    if run.get("phase") != "learning" or not spans._on_card(run):
        return None
    counters = spans._snapshot()["counters"]
    n = counters.get("learn.items")
    if not n:
        return None
    return 100.0 * counters.get("learn.kept_items", 0.0) / n
