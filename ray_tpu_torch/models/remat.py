"""Remat policies: what a layer's forward keeps for its backward.

Port of the reference's `_maybe_remat` (ray_tpu/models/transformer.py).
With `remat=True` each layer runs under torch.utils.checkpoint
(non-reentrant) while grad is enabled: the forward keeps the layer's
input, and the backward runs the layer again to get back the tensors its
gradients need.  A policy also keeps some of the layer's products from
the forward, and the re-run takes those instead of computing them again.

PyTorch's own policies (selective activation checkpointing) decide per
dispatcher op.  They cannot name the flash forward (its kernel launches
through ctypes, below the dispatcher), and they re-run every op they do
not keep, so they cannot keep q after rope without running its product
again.  So the products a policy may keep go through `Remat.run` by
name: the weight products (`linear` here, `_ProjRope` in
models/transformer.py) and the flash forward (ops/attention.py
`_FlashChunk`).  Each is an autograd Function that saves the same
tensors whether its value is computed or kept, since checkpoint's re-run
must save what the forward saved, in the same order.  Keeping changes no
value: a kept product is the forward's own tensor, and the recomputed
ones come from the same inputs through the same kernels.

Names, per layer:
  "q", "k", "v"      the products y @ wq, y @ wk, y @ wv; v enters the
                     flash kernel as it is (the reference's attn_v)
  "attn_q", "attn_k" q and k after rope, the flash kernel's inputs
  "attn"             the flash kernel's out and lse; under ring
                     attention step i's are "attn@<i>" (step 0's
                     "attn"), each kept by a policy that keeps "attn"
  "attn_proj"        attn @ wo
  "gate", "up"       y @ w_gate, y @ w_up
  "router"           the MoE router's logits

The dense MLP's last product, (gate * up) @ w_down, has no name: it
feeds only the residual sum, whose backward needs no value, and its
inputs are the last tensors the layer saves.  Autograd saves an op's
inputs before it runs the op, so checkpoint's early stop ends every
re-run there and the product never runs again (the reference drops it
the same way, by dead-code elimination).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

POLICIES: Dict[str, frozenset] = {
    # Only the layer input.
    "full": frozenset(),
    # jax.checkpoint_policies.dots_with_no_batch_dims_saveable: every
    # product of an activation by a weight.  Recomputed: the elementwise
    # work (norms, rope, SiLU), the flash forward (no dot in the
    # reference), the experts' batched products (batch dim e in the
    # reference's "ech,ehm->ecm") and the capacity route's dispatch and
    # combine (gathers here; einsums without batch dims that the
    # reference keeps).
    "dots": frozenset({"q", "k", "v", "attn_proj", "gate", "up", "router"}),
    # The flash kernel's out and lse: the backward never re-runs it.
    "save_attn": frozenset({"attn"}),
    # The attention side of "dots" after rope: q, k and v as the flash
    # kernel takes them, its out and lse, attn_proj.  Recomputed: gate
    # and up, and the whole MoE FFN (which the reference does not name).
    "dots_no_mlp": frozenset({"attn_q", "attn_k", "v", "attn",
                              "attn_proj"}),
}


def check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; expected "
                         "'full', 'dots', 'save_attn' or 'dots_no_mlp'")


class Remat:
    """One layer's checkpointed forward and its re-runs.

    The forward runs with `replay` False: `run` computes each product and
    keeps those the policy names.  The caller sets `replay` once the
    forward has returned; from then on `run` gives the kept products
    back and computes the rest again."""

    def __init__(self, policy: str):
        self.keep = POLICIES[policy]
        self.kept: Dict[str, object] = {}
        self.replay = False

    def run(self, name: str, fn: Callable[[], object]):
        if self.replay:
            if name in self.kept:
                # New tensor objects on the kept storage: the Function
                # that returns them sets their autograd history, not the
                # kept tensor's.
                return _detach(self.kept[name])
            return fn()
        out = fn()
        if name.split("@")[0] in self.keep:
            self.kept[name] = _detach(out)
        return out


def _detach(x):
    if isinstance(x, tuple):
        return tuple(t.detach() for t in x)
    return x.detach()


def run(memo: Optional[Remat], name: str, fn: Callable[[], object]):
    """fn() without a policy, else through the layer's `Remat`."""
    return fn() if memo is None else memo.run(name, fn)


class _Product(torch.autograd.Function):
    """a @ b, a [..., k] an activation, b [k, n] a weight (the two in one
    dtype), whose value a policy may keep.  The backward's two products
    are autograd's for a matmul: dA = dC b^T, dB = A^T dC over a's rows
    folded into one."""

    @staticmethod
    def forward(ctx, a, b, memo, name):
        ctx.save_for_backward(a, b)
        return run(memo, name, lambda: a @ b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g2 @ b.t()).view(a.shape)
        if ctx.needs_input_grad[1]:
            db = a.reshape(-1, a.shape[-1]).t() @ g2
        return da, db, None, None


def linear(a: torch.Tensor, b: torch.Tensor, memo: Optional[Remat] = None,
           name: str = "") -> torch.Tensor:
    """a @ b.  With grad enabled it goes through `_Product`, remat or not,
    so that every policy and none run the same backward; without grad
    (serving, evaluation) it is the plain product."""
    if not torch.is_grad_enabled():
        return a @ b
    return _Product.apply(a, b, memo, name)
