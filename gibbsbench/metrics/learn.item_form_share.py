"""learn.item_form_share: the share of the learn step kernel's items that
learn_item_kernel runs, items in parallel (the program's counter
``learn.item_form_items``, added at a kmax-2 step whose every tile fits
the item kernel), among all it launched (``learn.items``), both counted
by the host a launch from the tables, over the run's process, in
percent. A program without the counter (one older than the kmax-2 cut at
the item kernel's tile) gives None, as does a run off the card (a traced
slice with no device intervals), as the span readers do."""

from gibbsbench import spans


def read(run: dict):
    if run.get("phase") != "learning" or not spans._on_card(run):
        return None
    counters = spans._snapshot()["counters"]
    n = counters.get("learn.items")
    if not n or "learn.item_form_items" not in counters:
        return None
    return 100.0 * counters["learn.item_form_items"] / n
