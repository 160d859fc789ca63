"""Tensor parallelism beside a sequence split, on 4 gloo ranks of a (2, 2)
("data", "model") mesh: ``seq_tp`` prefill (the prompt's sequence over
``data``, tensors over ``model``), then ``ctx_tp`` decode (the cache's
sequence over ``data``, and over ``model`` too where the KV heads do not
divide it; the ranks' (output, log-sum-exp) merged over that group),
against the reference's sharded jit and the port's unsharded steps
(harness and what is held: tests/_sp_serving.py).

* gemma-2b: one KV head, so the decode cache's sequence lies over
  ``data`` x ``model``, four shares merged;
* mixtral-8x7b under ``ctx_tp_ep`` and ``ctx_tp_ep_q8``: heads over
  ``model`` and the sequence over ``data`` at once, windowed layers whose
  far share runs empty, the expert all-to-all over ``model`` with the
  batch whole on every ``data`` rank;
* whisper-tiny: the encoder's frames split over ``data``, the cross caches
  by heads over ``model``;
* llama-3.2-vision-11b: the prompt split over ``data`` beside the whole
  vision tokens (random, the gates opened to 0.5), its two-level cache.

The prompt lengths put some first decode positions at the shares'
boundaries (``LENS``).
"""

import pytest

from _sp_serving import check, check_split, run_cases, tag

MESH = (2, 2)
CASES = [("gemma-2b", 4, MESH, "seq_tp", "ctx_tp", None),
         ("mixtral-8x7b", 4, MESH, "seq_tp", "ctx_tp_ep", None),
         ("mixtral-8x7b", 4, MESH, "seq_tp", "ctx_tp_ep_q8", None),
         ("whisper-tiny", 4, MESH, "seq_tp", "ctx_tp", None),
         ("llama-3.2-vision-11b", 4, MESH, "seq_tp", "ctx_tp", None)]
IDS = [tag(*c) for c in CASES]


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_steps_equal_the_reference_and_unsharded(runs, case):
    check(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_weights_stay_split_and_activations_cross(runs, case):
    check_split(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_caches_lie_as_the_specs_say(runs, case):
    """The prompt's k (L, B, T, Hkv, hd) and the decode cache: the
    sequence over ``data`` (and ``model`` where the KV heads do not divide
    it), the heads over ``model`` where they do; the decode step merged
    over the sequence group (an all-gather of (out, LSE))."""
    from _sp_serving import cfg_of
    g = runs[1][tag(*case)]["got"]
    heads = cfg_of(case[0]).n_kv_heads % MESH[1] == 0
    seq = g["prefill_k"].ndim - 3                 # (..., B, S, Hkv, hd)
    want = (f"S({seq})", f"S({seq + 1})" if heads else f"S({seq})")
    assert g["layout"]["k"] == want, g["layout"]
    assert g["prefill_layout"]["k"] == want, g["prefill_layout"]
    kinds = [name.split("::")[-1] for name, _ in g["collectives"]]
    assert any("allgather" in k for k in kinds), kinds
