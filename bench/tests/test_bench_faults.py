"""A run at a tiny size on the CPU (the harness's look for a GPU skipped,
everything else as on the chip) with the timed path broken underneath
comes out not correct; unbroken, correct.  One test per fault a serving
cell can have: a step that leaves its state unchanged, half of the batch
left out, a token altered where it is produced (in every row, and in one
slot alone among the live ones).  (One chip: no exchange between chips to
leave out.)"""

import pytest
import torch

from bench.tests import _tiny

CELLS = ["mixtral-8x7b-l8.azconv_c256", _tiny.SSM_CELL]


def _state_unchanged(real):
    """The decode step computes on a copy of the cache: the engine's
    state never moves."""
    def apply_decode(self, params, cache, batch, **kw):
        logits, _ = real(self, params, {k: v.clone() for k, v in
                                        cache.items()}, batch, **kw)
        return logits, cache
    return apply_decode


def _half_batch(real):
    """Rows of the second half of the batch get no logits of their own."""
    def apply_decode(self, params, cache, batch, **kw):
        logits, cache = real(self, params, cache, batch, **kw)
        b = logits.shape[0]
        logits = logits.clone()
        logits[b // 2:] = 0.0
        return logits, cache
    return apply_decode


def _token_altered(real):
    """Each row's best logit moved one token over, where decode makes
    it."""
    def apply_decode(self, params, cache, batch, **kw):
        logits, cache = real(self, params, cache, batch, **kw)
        return torch.roll(logits, 1, dims=-1), cache
    return apply_decode


def _one_slot_altered(real):
    """Slot 0's best logit moved one token over; every other row
    untouched."""
    def apply_decode(self, params, cache, batch, **kw):
        logits, cache = real(self, params, cache, batch, **kw)
        logits = logits.clone()
        logits[0] = torch.roll(logits[0], 1, dims=-1)
        return logits, cache
    return apply_decode


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered,
          "one_slot_altered": _one_slot_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(cell):
    r = _tiny.run(cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, "apply_decode",
                        FAULTS[fault](Model.apply_decode))
    r = _tiny.run(cell)
    assert not r["correct"], r["compared"]
    assert list(r)[-1] == "compared"

