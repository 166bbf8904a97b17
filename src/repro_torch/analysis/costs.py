"""Analytic cost model and roofline terms for every (arch x shape) cell:
a copy of the JAX package's `analysis/costs.py` (numpy over `ArchConfig`;
the port imports nothing of the reference).

Exact einsum FLOP counts from the config, the MODEL_FLOPS = 6*N_active*D
convention, and parameter / activation byte estimates.  The job layer
(`repro_torch.net.jobs.compile_job`) reads `job_comm_terms`.

`PEAK_FLOPS`, `HBM_BW` and `ICI_BW` are parameters of the *simulated*
training cluster: the accelerator and link every simulated job runs on.
They set each job's compute:comm ratio and its seconds per simulator
tick, so they keep the reference's values for the port's ETTR to equal
the reference's.  They are not a speed of any card the port runs on.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = [
    "HW",
    "fwd_flops_per_token",
    "model_flops",
    "train_flops",
    "hbm_bytes",
    "param_count",
    "param_bytes",
    "roofline_terms",
    "job_comm_terms",
]

# the simulated cluster's accelerator and link (see the module docstring)
PEAK_FLOPS = 197e12       # bf16 FLOP/s per simulated chip
HBM_BW = 819e9            # bytes/s per simulated chip
ICI_BW = 50e9             # bytes/s per simulated link

HW = dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, ici_bw=ICI_BW)


def _attn_dims(cfg: ArchConfig):
    return cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim


def _per_kind_params(cfg: ArchConfig, kind: str, ffn: str) -> Dict[str, float]:
    """Active (per-token-used) and total params for one sublayer."""
    d, h, kvh, dh = _attn_dims(cfg)
    p: Dict[str, float] = {"total": 0.0, "active": 0.0}

    def add(n, active=True):
        p["total"] += n
        if active:
            p["active"] += n

    if kind in ("attn", "xattn"):
        add(d * h * dh * 2)        # wq, wo
        add(d * kvh * dh * 2)      # wk, wv
    elif kind == "mamba":
        inner = cfg.ssm_expand * d
        r = cfg.ssm_dt_rank or int(np.ceil(d / 16))
        add(d * 2 * inner)                      # in_proj
        add(inner * (r + 2 * cfg.ssm_d_state))  # x_proj
        add(r * inner)                          # dt_proj
        add(inner * d)                          # out_proj
        add(cfg.ssm_conv * inner)
    elif kind == "mlstm":
        inner = int(cfg.xlstm_proj_factor * d)
        add(d * 2 * inner)         # up
        add(3 * inner * inner)     # wq, wk, wv ([inner, h, dh], h*dh = inner)
        add(inner * 2 * cfg.n_heads)  # i/f gates
        add(inner * d)             # down
    elif kind == "slstm":
        add(d * 4 * d)             # w_x
        add(cfg.n_heads * (d // cfg.n_heads) * 4 * (d // cfg.n_heads))
        add(d * int(d * 4 / 3) * 2)  # gated ffn
    if ffn == "mlp":
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        add(mult * cfg.d_model * cfg.d_ff)
    elif ffn == "moe":
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        e_params = mult * cfg.d_model * cfg.d_ff
        add(cfg.moe_experts * e_params, active=False)
        # active share: top_k experts * capacity factor
        p["active"] += cfg.moe_top_k * e_params * cfg.capacity_factor
        add(cfg.d_model * cfg.moe_experts)  # router
        if cfg.moe_dense_ff:
            add(3 * cfg.d_model * cfg.moe_dense_ff)
    return p


def param_count(cfg: ArchConfig) -> Dict[str, float]:
    tot = act = 0.0
    for spec in cfg.period:
        pk = _per_kind_params(cfg, spec.kind, spec.ffn)
        tot += pk["total"] * cfg.n_periods
        act += pk["active"] * cfg.n_periods
    emb = cfg.vocab_size * cfg.d_model
    tot += emb * (1 if cfg.tie_embeddings else 2)
    act += emb * (1 if cfg.tie_embeddings else 2)
    if cfg.is_encdec:
        enc = _per_kind_params(cfg, "attn", "mlp")
        tot += enc["total"] * cfg.encoder_layers
        act += enc["active"] * cfg.encoder_layers
    return {"total": tot, "active": act}


def param_bytes(cfg: ArchConfig) -> float:
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return param_count(cfg)["total"] * itemsize


def fwd_flops_per_token(cfg: ArchConfig, seq_len: int, kv_len=None) -> float:
    """Forward FLOPs per token: 2*active_params + attention quadratic terms.

    kv_len: attention context per query token (decode: cache length)."""
    kv = kv_len if kv_len is not None else seq_len
    mat = 2.0 * param_count(cfg)["active"]
    # attention score+value flops per q token: 2 * 2 * kv_eff * h * dh
    d, h, kvh, dh = _attn_dims(cfg)
    attn_layers = sum(1 for s in cfg.period if s.kind == "attn") * cfg.n_periods
    kv_eff = min(cfg.window, kv) if cfg.window else kv
    causal_factor = 0.5 if kv_len is None else 1.0  # decode sees full cache
    quad = 4.0 * kv_eff * h * dh * attn_layers * causal_factor
    if cfg.is_encdec:
        # cross attention over enc_len = seq_len + encoder self-attn
        x_layers = sum(1 for s in cfg.period if s.kind == "xattn") * cfg.n_periods
        quad += 4.0 * kv * h * dh * x_layers
        quad += 4.0 * kv * h * dh * cfg.encoder_layers * 1.0  # encoder, non-causal
    return mat + quad


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS convention: 6*N*D (dense) / 6*N_active*D (MoE)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * param_count(cfg)["active"] * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * param_count(cfg)["active"] * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * param_count(cfg)["active"] * tokens


def train_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Analytic compiled-compute estimate for one step (global, all chips).

    train: fwd + 2x bwd + 1x remat recompute = 4x fwd.
    prefill: fwd.  decode: fwd with kv_len context."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 4.0 * fwd_flops_per_token(cfg, S) * B * S
    if shape.kind == "prefill":
        return 1.0 * fwd_flops_per_token(cfg, S) * B * S
    return 1.0 * fwd_flops_per_token(cfg, 1, kv_len=S) * B


def hbm_bytes(cfg: ArchConfig, shape: ShapeSpec, chips: int) -> float:
    """Per-device HBM traffic estimate for one step: parameters are read
    (fwd + bwd + remat) and written (optimizer), activations stream once
    per direction, KV cache read for decode."""
    B, S = shape.global_batch, shape.seq_len
    pbytes = param_bytes(cfg)
    act_itemsize = 2
    d = cfg.d_model
    if shape.kind == "train":
        # 3 reads (fwd/bwd/remat) + grad write + opt read/write ~ 6x params
        p_traffic = 6.0 * pbytes
        act = 4.0 * B * S * d * cfg.n_layers * act_itemsize
        total = p_traffic + act
    elif shape.kind == "prefill":
        total = pbytes + 2.0 * B * S * d * cfg.n_layers * act_itemsize
    else:
        kv_layers = sum(1 for s in cfg.period if s.kind in ("attn", "xattn"))
        kv_layers *= cfg.n_periods
        kv_eff = min(cfg.window, S) if cfg.window else S
        kv_itemsize = 1 if cfg.kv_quant else act_itemsize  # int8 KV cache
        kv_bytes = (
            2.0 * B * kv_eff * cfg.n_kv_heads * cfg.head_dim * kv_itemsize
            * kv_layers
        )
        total = pbytes + kv_bytes
    return total / chips


def job_comm_terms(
    cfg: ArchConfig,
    shape: ShapeSpec,
    *,
    dp: int,
    tp: int,
) -> Dict[str, float]:
    """Per-iteration compute/communication terms for a DP x TP training job.

    This is the analytic contract between the model zoo and the job-level
    network simulation (`repro_torch.net.jobs`): a training iteration's exposed
    communication is dominated by two data-parallel ring collectives over
    the DCN-class fabric —

      * allreduce of the gradients (bf16, 1/tp of the model each rank
        holds): ring wire bytes = 2 * (dp-1)/dp * grad_bytes;
      * allgather of the updated parameters (ZeRO-style sharded optimizer
        states): ring wire bytes = (dp-1)/dp * param_bytes / tp.

    Compute is the roofline compute term of one step on dp*tp chips.  The
    returned dict carries bytes (exact from the config) and seconds (from
    the simulated cluster's constants); `repro_torch.net.jobs.compile_job` converts them into
    simulator packets and ticks.
    """
    if dp < 2:
        raise ValueError(f"job_comm_terms needs dp >= 2 ring workers, got {dp}")
    chips = dp * tp
    grad_itemsize = 2  # bf16 gradients on the wire regardless of param dtype
    grad_bytes = param_count(cfg)["total"] * grad_itemsize / tp
    pbytes = param_bytes(cfg) / tp
    t_compute_s = train_flops(cfg, shape) / (chips * PEAK_FLOPS)
    allreduce_wire = 2.0 * (dp - 1) / dp * grad_bytes
    allgather_wire = (dp - 1) / dp * pbytes
    return {
        "grad_bytes": grad_bytes,
        "param_bytes": pbytes,
        "allreduce_wire_bytes": allreduce_wire,
        "allgather_wire_bytes": allgather_wire,
        "t_compute_s": t_compute_s,
        "t_allreduce_s": allreduce_wire / ICI_BW,
        "t_allgather_s": allgather_wire / ICI_BW,
        "compute_comm_ratio": t_compute_s
        / max((allreduce_wire + allgather_wire) / ICI_BW, 1e-12),
    }


def roofline_terms(
    cfg: ArchConfig,
    shape: ShapeSpec,
    chips: int,
    *,
    measured_flops: float | None = None,
    measured_bytes: float | None = None,
    collective_bytes_per_dev: float | None = None,
) -> Dict[str, float]:
    """The three roofline terms (seconds) + bookkeeping.

    compute    <- ``measured_flops`` when given, else the analytic count;
    memory     <- the analytic traffic model (``measured_bytes`` is taken
                  for the reference's signature and not used);
    collective <- ``collective_bytes_per_dev`` wire bytes."""
    flops_global = measured_flops if measured_flops else train_flops(cfg, shape)
    bytes_dev = hbm_bytes(cfg, shape, chips)
    del measured_bytes  # diagnostic only — see docstring
    coll_dev = collective_bytes_per_dev or 0.0
    t_compute = flops_global / (chips * PEAK_FLOPS)
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / ICI_BW
    mf = model_flops(cfg, shape)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    t_bound = max(t_compute, t_memory, t_coll)
    t_serial = t_compute + t_memory + t_coll
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops": flops_global,
        "useful_ratio": mf / flops_global if flops_global else 0.0,
        # perfect comm/compute overlap: step time = max(terms)
        "roofline_fraction": t_compute / t_bound if t_bound > 0 else 0.0,
        # zero overlap: step time = sum(terms) — the conservative score
        "roofline_fraction_serial": (
            t_compute / t_serial if t_serial > 0 else 0.0
        ),
    }
