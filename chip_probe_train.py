#!/usr/bin/env python3
"""One-off measurements of the port's training path on one CUDA card.

    python3 chip_probe_train.py      # from the repository root; one GPU

``chip_smoke.py`` checks the training path; this script checks nothing and
decides nothing.  It measures what the design rests on:

1. the reference's init at llama3_8b's widths (8 of its 32 layers, the
   depth of ``chip_smoke.py``'s ``train_full_width``): one sequence's loss
   and gradient norm, and the first 2 layers' bf16 gradients against
   fp32 copies of the same params (``train_full_width`` rescales the
   attention weights first, because this init saturates attention);
2. one product's backward at full width (``w_up``'s, [8192, 4096] x
   [4096, 14336], an fp32 cotangent): the cotangent rounded to bf16 (the
   port's choice in ``layers._F32Product``) against the bf16 operands
   widened to fp32, the time of each and the gap between them.

Prints one JSON line a probe, then the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

import chip_smoke as cs
from repro_torch import configs as cfgs
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw


def reference_init() -> dict:
    """The reference's init at llama3_8b's widths, 8 layers."""
    cfg = dataclasses.replace(cfgs.get_config(cs.FULL_ARCH),
                              n_layers=cs.FULL_TRAIN_DEPTH)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    params = TT.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (1, cs.FULL_TRAIN_SEQ), generator=gen,
                         device=cs.DEVICE, dtype=torch.int32)
    loss, grads = cs.smoke_loss_grads(cfg, params, toks, None)
    out = {"probe": "reference_init_one_sequence", "arch": cfg.name,
           "layers": cfg.n_layers, "tokens": int(toks.numel()),
           "loss": float(loss),
           "grad_norm": float(adamw.global_norm(list(grads)))}
    del grads
    out["two_layers_bf16_vs_fp32"] = cs.model_grad_gap(
        cfg, params, toks[:, :cs.FULL_HEAD_SEQ])["max_gap"]
    return out


def backward_choice() -> dict:
    """``w_up``'s product backward: cotangent narrowed against operands
    widened."""
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 12)
    T, d, f = cs.FULL_TRAIN_BATCH * cs.FULL_TRAIN_SEQ, 4096, 14336
    a = torch.randn((T, d), generator=gen, device=cs.DEVICE).to(
        torch.bfloat16)
    b = torch.randn((d, f), generator=gen, device=cs.DEVICE).to(
        torch.bfloat16)
    g = torch.randn((T, f), generator=gen, device=cs.DEVICE)

    def narrowed():
        g16 = g.to(torch.bfloat16)
        return (torch.mm(g16, b.t(), out_dtype=torch.float32).to(a.dtype),
                torch.mm(a.t(), g16, out_dtype=torch.float32).to(b.dtype))

    def widened():
        return ((g @ b.float().t()).to(a.dtype),
                (a.float().t() @ g).to(b.dtype))

    out = {"probe": "backward_choice", "shape": [T, d, f],
           "narrowed_ms": cs.time_ms(narrowed, cs.MODEL_REPS),
           "widened_ms": cs.time_ms(widened, 2)}
    out["gap_a"], out["gap_b"] = cs.leaf_gaps(narrowed(), widened())
    out["flops"] = 2 * 2 * T * d * f
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_probe_train: no CUDA device")
    smi = cs.card_identity()
    cs.emit(reference_init())
    torch.cuda.empty_cache()
    cs.emit(backward_choice())
    print(smi)


if __name__ == "__main__":
    main()
