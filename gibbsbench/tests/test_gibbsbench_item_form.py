"""The reader of ``learn.item_form_share``: 100 x the program's counter
``learn.item_form_items`` over ``learn.items``, read from the registry
of its run's process, and nothing without the counter, outside learning
or off the card (a traced slice with no device intervals)."""

import importlib.util
import os

import pytest

from numbskull_tpu_torch.observability import metrics

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = {"phase": "learning", "trace": {"busy_s": 0.5, "window_s": 1.0}}


def _read():
    spec = importlib.util.spec_from_file_location(
        "reader", os.path.join(HERE, "metrics", "learn.item_form_share.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("form, items, share", [
    (3500.0, 3500.0, 100.0), (1000.0, 4000.0, 25.0), (0.0, 4000.0, 0.0)])
def test_reads_the_counter_ratio(form, items, share):
    read = _read()
    metrics.reset()
    metrics.add("learn.items", items)
    metrics.add("learn.item_form_items", form)
    assert read(CARD) == share
    metrics.reset()


def test_finds_nothing_without_the_counter_or_off_the_card():
    read = _read()
    metrics.reset()
    metrics.add("learn.items", 4000.0)
    assert read(CARD) is None                    # an older program
    metrics.add("learn.item_form_items", 4000.0)
    assert read(CARD) == 100.0
    assert read({}) is None
    assert read({"phase": "learning"}) is None   # no traced slice
    assert read({"phase": "learning",            # no device intervals
                 "trace": {"busy_s": None, "window_s": 1.0}}) is None
    assert read(dict(CARD, phase="inference")) is None
    metrics.reset()
    assert read(CARD) is None                    # nothing launched
