"""Headline benchmark: transformer training throughput on one GPU.

Port of the repository's bench.py.  Prints ONE JSON line:
  {"metric": "train_mfu", "value": <fraction>, "unit": "MFU",
   "vs_baseline": <value / 0.40>, ...}

MFU = tokens/s x flops_per_token (model FLOPs, 6N + attention; remat's
recompute not counted) / the card's peak bf16 dense rate.  The ladders and
configs are the reference's; the first config that fits wins, walking
down on torch.cuda.OutOfMemoryError only.  Runs on the CUDA device;
`main(device="cpu")` is the CPU smoke mode (tiny config, same code path).

    python -m ray_tpu_torch.bench
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ray_tpu_torch.util import device_stats


def _peak_flops(device: torch.device) -> float:
    """The card's peak bf16 dense FLOP/s, from util/device_stats.py's
    peak table (NVIDIA data sheets, without sparsity)."""
    if device.type == "cpu":
        return 1e12  # nominal, so the CPU smoke run still prints a line
    kind = torch.cuda.get_device_name(device)
    spec = device_stats.peak_specs_for(kind)
    if spec is None:
        raise ValueError(f"no peak FLOP/s known for {kind!r}")
    return spec[1]


def _config_ladder(tfm):
    """Largest-first configs at seq 2048, head_dim 128, full remat and
    fused CE, AdamW mu and nu in bf16 (the reference's ladder)."""
    base = dict(vocab_size=32000, max_seq_len=2048, remat_policy="full",
                fused_ce=True)
    return [
        ("0.9B", tfm.TransformerConfig(
            hidden_size=1792, intermediate_size=7168, num_layers=16,
            num_heads=14, num_kv_heads=14, **base), 8, 2048),
        ("0.9B-b6", tfm.TransformerConfig(
            hidden_size=1792, intermediate_size=7168, num_layers=16,
            num_heads=14, num_kv_heads=14, **base), 6, 2048),
        ("0.8B", tfm.TransformerConfig(
            hidden_size=1536, intermediate_size=6144, num_layers=20,
            num_heads=12, num_kv_heads=12, **base), 8, 2048),
        ("0.5B", tfm.TransformerConfig(
            hidden_size=1536, intermediate_size=6144, num_layers=12,
            num_heads=12, num_kv_heads=12, **base), 8, 2048),
    ]


def _long_context_ladder(tfm):
    """seq-8192 rows: the same 0.9B model, 8k context, full remat."""
    base = dict(vocab_size=32000, hidden_size=1792,
                intermediate_size=7168, num_layers=16, num_heads=14,
                num_kv_heads=14, max_seq_len=8192,
                remat_policy="full", fused_ce=True)
    return [
        ("0.9B-seq8k", tfm.TransformerConfig(**base), 2, 8192),
        ("0.9B-seq8k-b1", tfm.TransformerConfig(**base), 1, 8192),
    ]


def _large_model_ladder(tfm):
    return [
        ("1.0B", tfm.TransformerConfig(
            vocab_size=32000, hidden_size=2048, intermediate_size=7168,
            num_layers=16, num_heads=16, num_kv_heads=16,
            max_seq_len=2048, remat_policy="full", fused_ce=True),
         6, 2048),
    ]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_once(config, batch, seq, steps, device):
    """(mfu, tokens/s, final loss) of `steps` timed steps after one
    warm-up step, random weights and tokens from seed 0."""
    import numpy as np

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train.train_state import (
        ShardedTrainStep,
        default_optimizer,
    )

    device = torch.device(device)
    ts = ShardedTrainStep(
        config, device=device,
        optimizer=default_optimizer(warmup_steps=10, total_steps=1000,
                                    mu_dtype=torch.bfloat16,
                                    nu_dtype=torch.bfloat16))
    state = ts.init(0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (batch, seq + 1))).to(device)
    batch_t = {"tokens": tokens}

    state, metrics = ts.step(state, batch_t)  # warm-up
    float(metrics["loss"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = ts.step(state, batch_t)
    final_loss = float(metrics["loss"])
    dt = time.perf_counter() - t0

    tok_per_sec = batch * seq * steps / dt
    mfu = tok_per_sec * tfm.flops_per_token(config, seq) / _peak_flops(
        device)
    return mfu, tok_per_sec, final_loss


def _run_ladder(ladder, steps, device):
    """First config that fits wins (out of memory walks down)."""
    for name, config, batch, seq in ladder:
        try:
            mfu, tok_per_sec, final_loss = _run_once(
                config, batch, seq, steps, device)
            return (name, config, batch, seq, mfu, tok_per_sec, final_loss)
        except torch.cuda.OutOfMemoryError:
            import traceback

            traceback.print_exc(file=sys.stderr)
            print(f"# {name} did not fit; trying next config",
                  file=sys.stderr)
            torch.cuda.empty_cache()
    return None


def _row_json(tfm, result):
    name, config, batch, seq, mfu, tok_per_sec, final_loss = result
    return {
        "model": name,
        "mfu": round(mfu, 4),
        "tokens_per_sec_per_chip": round(tok_per_sec, 1),
        "model_params": tfm.num_params(config),
        "seq_len": seq,
        "batch": batch,
        "final_loss": round(final_loss, 4),
    }


def main(device=None) -> int:
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import transformer as tfm

    device = resolve_device(device)
    if device.type == "cuda":
        headline = _config_ladder(tfm)
        extra_ladders = [_long_context_ladder(tfm), _large_model_ladder(tfm)]
        steps = 20
        kind = torch.cuda.get_device_name(device)
    else:  # CPU smoke mode: same code path, tiny shapes
        headline = [("tiny", tfm.TransformerConfig.tiny(), 4, 64)]
        extra_ladders = []
        steps = 3
        kind = "cpu"

    result = _run_ladder(headline, steps, device)
    if result is None:
        print(json.dumps({"metric": "train_mfu", "value": 0.0,
                          "unit": "MFU", "vs_baseline": 0.0,
                          "error": "all configs ran out of memory"}))
        return 1
    rows = []
    for ladder in extra_ladders:
        extra = _run_ladder(ladder, steps, device)
        if extra is not None:
            rows.append(_row_json(tfm, extra))
    mfu = result[4]
    head = _row_json(tfm, result)
    print(json.dumps({
        "metric": "train_mfu",
        "value": round(mfu, 4),
        "unit": "MFU",
        "vs_baseline": round(mfu / 0.40, 4),
        **{k: v for k, v in head.items() if k != "mfu"},
        "device": kind,
        "n_devices": 1,
        "extra_rows": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
