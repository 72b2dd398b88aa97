"""Faults planted under the AFMoE serving path (``afmoe_serve``), each a
context manager that patches the program while it is active: what
``bench/calibrate.py`` reads on the chip and what the tests see turn
``correct`` false.  Each leaves out or alters one equation of
``bench/reference/afmoe.py``:

- ``window``: the sliding layers attend without their window (prefill);
- ``rope_global``: RoPE on the full layers too;
- ``no_gate``: the attention output gate skipped;
- ``no_shared``: the shared expert skipped;
- ``softmax``: router scores by softmax instead of sigmoid;
- ``bias_in_weights``: the expert bias added to the scores the weights
  are taken from, not only to those the experts are chosen by;
- ``no_route_scale``: the routing weights left unscaled;
- ``no_post_norm``: the post-MLP norm skipped.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("window", "rope_global", "no_gate", "no_shared", "softmax", "bias_in_weights",
          "no_route_scale", "no_post_norm")


class _Without:
    """A param dict as the program reads it (``p[key]``, ``key in p``),
    minus ``keys``."""

    def __init__(self, p, *keys):
        self.p, self.keys = p, keys

    def __getitem__(self, key):
        if key in self.keys:
            raise KeyError(key)
        return self.p[key]

    def __contains__(self, key):
        return key not in self.keys and key in self.p


def _route(fault: str):
    """``moe.route`` with one of its steps altered."""
    def route(x2d, router_w, cfg, bias=None):
        logits = x2d.float() @ router_w.float()
        scores = torch.softmax(logits, -1) if fault == "softmax" else torch.sigmoid(logits)
        pick = scores + bias.float()
        top_i = torch.topk(pick, cfg.top_k, dim=-1).indices
        top_w = (pick if fault == "bias_in_weights" else scores).gather(-1, top_i)
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        if fault != "no_route_scale":
            top_w = top_w * cfg.route_scale
        return top_i.to(torch.int32), top_w.to(x2d.dtype)

    return route


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.zoo.models import moe, transformer

    if name not in FAULTS:
        raise KeyError(f"no fault {name!r}; have {FAULTS}")
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in (
        (transformer, "attention"), (transformer, "moe_apply"), (transformer, "apply_layer"),
        (moe, "route"))]
    attention, moe_apply, apply_layer = transformer.attention, transformer.moe_apply, \
        transformer.apply_layer
    if name == "window":
        def attend(x, p, cfg, *, window=0, **kw):
            return attention(x, p, cfg, window=0, **kw)

        transformer.attention = attend
    elif name == "rope_global":
        def attend(x, p, cfg, *, rotary=True, **kw):
            return attention(x, p, cfg, rotary=True, **kw)

        transformer.attention = attend
    elif name == "no_gate":
        transformer.attention = lambda x, p, cfg, **kw: attention(x, _Without(p, "wgate"), cfg,
                                                                  **kw)
    elif name == "no_shared":
        transformer.moe_apply = lambda x, p, cfg: moe_apply(x, _Without(p, "shared"), cfg)
    elif name == "no_post_norm":
        transformer.apply_layer = lambda x, lp, *a, **kw: apply_layer(
            x, _Without(lp, "ln2_post"), *a, **kw)
    else:
        moe.route = _route(name)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
