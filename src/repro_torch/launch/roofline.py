"""Roofline analysis over dry-run results, on the H100's figures.

Copy of ``repro.launch.roofline``.  Three terms, in seconds, per (arch x
shape) from ``launch.dryrun``'s counts (per device):

  compute    = FLOPs / 989e12            (H100 SXM bf16 dense peak)
  memory     = bytes accessed / 3.35e12  (HBM3)
  collective = wire bytes / 450e9        (NVLink 4, one direction)

The figures are ``launch.mesh``'s datasheet peaks.  Wire bytes apply
ring-collective factors to the collectives' result bytes, which the
dry-run tallies per device on the production meshes (empty on the
one-card mesh).

MODEL_FLOPS = 6*N*D (train), 2*N*D (prefill), 2*N_active*B (decode) —
the "useful" work the counted FLOPs are judged against; ``ideal_s`` is
the larger of the useful FLOPs at peak and one read of the arguments
(params, optimizer state, batch or cache) at the HBM rate.

Results are read from ``ARTIFACT_DIR`` (``artifacts/dryrun_torch/``,
apart from the reference's ``artifacts/dryrun/``): ``load_results()``
reads the one-card files (``*_card.json``), ``load_results(True)`` the
2x16x16 ones and ``load_results(mesh="pod")`` the 16x16 ones; a file
without ``flops`` (a memory-only record: ``--no-cost``, or a production
mesh's whose sharded step failed, ``sharded_error``) is skipped.

    python -m repro_torch.launch.roofline [card|pod|multipod]
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

_WIRE_FACTOR = {          # per-device bytes-on-wire per full-tensor byte
    "all-gather": 1.0,        # (n-1)/n ≈ 1
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,        # RS + AG
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclass
class Roofline:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    arg_bytes: float = 0.0      # per-device params+state: one mandatory read

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/masking/dispatch overhead."""
        return self.model_flops / self.hlo_flops if self.hlo_flops > 0 else 0.0

    @property
    def ideal_s(self) -> float:
        """Roofline floor: useful FLOPs at peak, or one full HBM read of
        params+state (whichever binds) — decode is memory-bound, so its
        floor is the weight/KV-streaming time."""
        return max(self.model_flops / PEAK_FLOPS_BF16, self.arg_bytes / HBM_BW)

    @property
    def roofline_fraction(self) -> float:
        """ideal_s / the counted work's bound."""
        return self.ideal_s / self.bound_s if self.bound_s > 0 else 0.0


def _attn_flops_per_token(cfg, ctx: int, causal: bool) -> float:
    """Useful attention/SSD mixer FLOPs per token (QK^T + PV = 4*H*hd*ctx)."""
    total = 0.0
    pattern = cfg.resolved_pattern
    n_rep = cfg.num_layers // len(pattern)
    for kind in pattern:
        if kind == "mamba":
            m = cfg.mamba
            di = m.d_inner(cfg.d_model)
            # intra-chunk quadratic + state read/write
            total += (2 * m.chunk * di + 4 * di * m.d_state) * n_rep
            continue
        eff = ctx / 2 if causal else ctx
        if kind == "attn_swa" and cfg.sliding_window:
            eff = min(eff, cfg.sliding_window)
        total += 4 * cfg.num_heads * cfg.resolved_head_dim * eff * n_rep
    if cfg.enc_dec:  # encoder self-attention (bidirectional)
        total += 4 * cfg.num_heads * cfg.resolved_head_dim * ctx * cfg.num_encoder_layers
    return total


def model_flops(cfg, cell, n_active: int, chips: int) -> float:
    """Per-device useful FLOPs of ``cell`` on ``cfg``: 2N per token (6N
    train) + the attention/SSD term."""
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        attn = _attn_flops_per_token(cfg, cell.seq_len, causal=True) * tokens
        return (6.0 * n_active * tokens + 3.0 * attn) / chips
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        attn = _attn_flops_per_token(cfg, cell.seq_len, causal=True) * tokens
        return (2.0 * n_active * tokens + attn) / chips
    # decode: 1 new token per sequence against a ctx-long cache
    attn = _attn_flops_per_token(cfg, cell.seq_len, causal=False) * cell.global_batch
    return (2.0 * n_active * cell.global_batch + attn) / chips


def model_flops_for(result: dict) -> float:
    """``model_flops`` of a dry-run result (its arch, shape cell, active
    parameters and device count)."""
    from repro_torch.configs.base import ALL_SHAPES, get_config
    cell = {c.name: c for c in ALL_SHAPES}[result["shape"]]
    n_active = result.get("params_active") or result["params"]
    return model_flops(get_config(result["arch"]), cell, n_active,
                       result["chips"])


def analyze(result: dict) -> Roofline:
    flops = result["flops"]
    hbytes = result["bytes_accessed"]
    wire = 0.0
    for op, b in result["collectives"]["bytes_by_op"].items():
        wire += b * _WIRE_FACTOR.get(op, 1.0)
    return Roofline(
        arch=result["arch"], shape=result["shape"],
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=hbytes / HBM_BW,
        collective_s=wire / LINK_BW,
        model_flops=model_flops_for(result),
        hlo_flops=flops,
        arg_bytes=float(result.get("memory", {}).get("argument_size_in_bytes", 0)),
    )


def load_results(multi_pod: bool = False, mesh: str = "") -> list[dict]:
    tag = mesh or ("multipod" if multi_pod else "card")
    out = []
    if not os.path.isdir(ARTIFACT_DIR):
        return out
    for f in sorted(os.listdir(ARTIFACT_DIR)):
        if f.endswith(f"_{tag}.json"):
            with open(os.path.join(ARTIFACT_DIR, f)) as fh:
                r = json.load(fh)
            if "flops" in r:
                out.append(r)
    return out


def table(multi_pod: bool = False, mesh: str = "") -> str:
    rows = ["arch,shape,compute_s,memory_s,collective_s,dominant,"
            "model_flops,hlo_flops,useful_ratio,roofline_fraction"]
    for r in load_results(multi_pod, mesh):
        a = analyze(r)
        rows.append(
            f"{a.arch},{a.shape},{a.compute_s:.4e},{a.memory_s:.4e},"
            f"{a.collective_s:.4e},{a.dominant},{a.model_flops:.3e},"
            f"{a.hlo_flops:.3e},{a.useful_ratio:.3f},{a.roofline_fraction:.3f}")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# Serving-profile fallback (used by core.profiles.arch_profile when no
# dry-run result exists)
# ---------------------------------------------------------------------------
def decode_step_time_fallback(arch: str) -> float:
    """Per-decode-step seconds for a batch, memory-bound: 2 bytes a
    active parameter over ONE card's HBM rate.  The reference divides by
    8 chips' (an 8-chip TPU serving slice); the port serves a model on
    one H100, every replica reading the whole of its weights each step
    (``launch.serve``), so one card's rate is the floor."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry as R
    cfg = get_config(arch)
    n_active = R.count_params(cfg, active=True)
    bytes_per_step = 2.0 * n_active
    return bytes_per_step / HBM_BW


def decode_step_time(arch: str, shape: str = "decode_32k") -> float:
    """Roofline-derived decode step time from the one-card dry-run result,
    else the fallback."""
    path = os.path.join(ARTIFACT_DIR, f"{arch}_{shape}_card.json")
    if os.path.exists(path):
        with open(path) as f:
            r = json.load(f)
        if "flops" in r:
            return analyze(r).bound_s
    return decode_step_time_fallback(arch)


if __name__ == "__main__":
    import sys
    print(table(mesh=sys.argv[1] if len(sys.argv) > 1 else ""))
