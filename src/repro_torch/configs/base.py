"""Config dataclasses of the PyTorch port: model, elastic, optimizer.

Field names, defaults and ``__post_init__`` validation mirror
``repro.configs.base`` so that a configuration means the same run in both
packages. ``ModelConfig`` keeps the fields the paper's CNN and the
model families the port runs (dense, mixture-of-experts,
encoder-decoder and vision-language) read;
``use_pallas`` is not carried across — the
device of the tensors picks kernel or plain version. ``get_config``
resolves the ported architectures and refuses every other by name.

Configs are plain data and validate as the reference's do: sharded
placement needs fused comm (the reference's own ``ValueError``). Sharded
placement runs in the port: the trainer splits the slot axis over the
ranks of a ``torch.distributed`` group (world size 1 without one), the
session pads the capacity to a multiple of the world size, and the CLI's
``--coordinator-address`` / ``--num-processes`` / ``--process-id`` start
one process per rank (``repro_torch.launch.mesh``). With one card, ranks
share it over gloo; NCCL needs a card per rank.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "cnn" | "dense" | "moe" | "encdec" | "vlm" run in the port
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    # norms / activations
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | gelu | geglu
    qk_norm: bool = False
    # rope
    rope_mode: str = "standard"  # standard | mrope | none
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    mrope_sections: Tuple[int, ...] = ()
    # attention locality
    sliding_window: Optional[int] = None
    attention_chunk: Optional[int] = None
    # embeddings
    tie_embeddings: bool = False
    # MoE (nn/moe.py: routed experts, shared experts, first dense layers)
    num_experts: int = 0
    top_k: int = 1
    num_shared_experts: int = 0
    expert_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    router_aux_weight: float = 0.01
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq_ratio: int = 8  # decoder_len / encoder_len for shape derivation
    # modality stubs
    frontend: Optional[str] = None  # 'audio' | 'vision' | None
    num_patch_tokens: int = 0  # vlm: patch embeddings prepended per sample
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    source: str = ""  # citation

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @property
    def e_dff(self) -> int:
        return self.expert_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# Failure scenario catalogue (generators in repro_torch/core/scenarios.py).
FAILURE_SCENARIOS = ("iid", "burst", "correlated", "straggler",
                     "crash_restart", "hetero", "byzantine")

# Membership scenario catalogue (planned worker-pool resize streams).
MEMBERSHIP_SCENARIOS = ("static", "scale_up", "scale_down",
                        "preempt_rejoin", "plan")


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Paper Section V hyper-parameters (see ``repro.configs.base`` for the
    meaning of every knob; the two packages share names and defaults)."""

    num_workers: int = 4
    capacity: int = 0                 # worker-pool slots; 0 = num_workers
    tau: int = 1                      # communication period
    alpha: float = 0.1                # EASGD moving rate (best grid value, §VII)
    score_window: int = 5             # p most-recent u values kept (p-1 diffs)
    score_weights: Tuple[float, ...] = (0.5, 0.25, 0.15, 0.10)  # c_0 (newest) .. c_{p-2}
    score_k: float = -0.05            # threshold k < 0 in h1/h2
    overlap_ratio: float = 0.25       # r = o/n (paper: .25 @ k=4, .125 @ k=8)
    failure_prob: float = 1.0 / 3.0   # comm suppressed 1/3 of the time (§VI)
    dynamic: bool = True              # False → fixed-α EASGD behaviour
    oracle: bool = False              # EAHES-OM: oracle failure knowledge
    # "sequential": the paper's event-ordered scan over workers, the master
    # updated between workers. "fused": one batched scoring pass and one
    # multi-worker elastic exchange against the round-start master, with
    # event-order-equivalent master weights.
    comm_mode: str = "sequential"     # sequential | fused
    # Delayed averaging depth (DaSGD): 1 = score and pull toward the
    # previous round's master snapshot. Fused mode only.
    staleness: int = 0                # 0 | 1
    placement: str = "single"         # single | sharded
    failure_scenario: str = "iid"
    burst_recover_prob: float = 0.25  # burst/straggler: P(bad→good)/round
    fault_groups: int = 2             # correlated: number of co-failing racks
    crash_downtime: int = 3           # crash_restart: rounds down per crash
    straggler_tau_scale: float = 0.5  # straggler: fraction of τ it completes
    hetero_dist: str = "lognormal"    # lognormal | bimodal
    hetero_sigma: float = 0.6         # lognormal: speed = min(1, exp(sigma·z))
    hetero_slow_frac: float = 0.25    # bimodal: P(slot is slow)
    hetero_slow_scale: float = 0.25   # bimodal: speed of slow slots
    byzantine_frac: float = 0.25      # P(slot is corrupt) — persistent
    byzantine_mode: str = "sign_flip"  # sign_flip | scale | noise
    byzantine_scale: float = 5.0      # scale factor / noise std
    # Robustness clamp for dynamic weighting: w2 = 0 for raw scores above
    # +score_clip (0 disables it, bit-identical to the paper's maps).
    score_clip: float = 0.0
    u_zclip: float = 0.0              # absolute-distance containment
    groups: int = 1                   # hierarchical averaging racks
    global_period: int = 1            # rounds between global syncs
    membership_scenario: str = "static"
    membership_k: int = 0
    membership_round: int = 0
    membership_plan: Tuple[Tuple[int, int], ...] = ()

    @property
    def cap(self) -> int:
        """Padded worker-axis length: ``capacity`` slots (>= num_workers),
        or exactly ``num_workers`` when capacity is left at 0."""
        return self.capacity or self.num_workers

    @property
    def hierarchical(self) -> bool:
        return self.groups > 1 or self.global_period > 1

    def __post_init__(self):
        if self.comm_mode not in ("sequential", "fused"):
            raise ValueError(
                f"comm_mode must be 'sequential' or 'fused', "
                f"got {self.comm_mode!r}")
        if self.placement not in ("single", "sharded"):
            raise ValueError(
                f"placement must be 'single' or 'sharded', "
                f"got {self.placement!r}")
        if self.placement == "sharded" and self.comm_mode != "fused":
            raise ValueError(
                "placement='sharded' requires comm_mode='fused': the "
                "sequential backend is an event-ordered scan over workers "
                "and cannot be placed on disjoint mesh shards")
        if self.staleness not in (0, 1):
            raise ValueError(
                f"staleness must be 0 or 1, got {self.staleness!r}")
        if self.staleness and self.comm_mode != "fused":
            raise ValueError(
                "staleness=1 (delayed averaging) requires comm_mode='fused':"
                " the sequential backend is the paper's event-ordered scan "
                "against the live master, where a stale sync target has no "
                "consistent meaning")
        if self.failure_scenario not in FAILURE_SCENARIOS:
            raise ValueError(
                f"failure_scenario must be one of {FAILURE_SCENARIOS}, "
                f"got {self.failure_scenario!r}")
        if self.num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {self.num_workers}")
        if self.capacity and self.capacity < self.num_workers:
            raise ValueError(
                f"capacity={self.capacity} must be >= "
                f"num_workers={self.num_workers} (capacity pads the worker "
                "axis; it cannot truncate the initial membership)")
        if self.hetero_dist not in ("lognormal", "bimodal"):
            raise ValueError(
                f"hetero_dist must be 'lognormal' or 'bimodal', "
                f"got {self.hetero_dist!r}")
        if self.hetero_sigma <= 0:
            raise ValueError(
                f"hetero_sigma must be > 0, got {self.hetero_sigma}")
        if not 0.0 <= self.hetero_slow_frac <= 1.0:
            raise ValueError(
                f"hetero_slow_frac must be in [0, 1], "
                f"got {self.hetero_slow_frac}")
        if not 0.0 < self.hetero_slow_scale <= 1.0:
            raise ValueError(
                f"hetero_slow_scale must be in (0, 1], "
                f"got {self.hetero_slow_scale}")
        if not 0.0 <= self.byzantine_frac < 1.0:
            raise ValueError(
                f"byzantine_frac must be in [0, 1) — at least one slot "
                f"must stay honest — got {self.byzantine_frac}")
        if self.byzantine_mode not in ("sign_flip", "scale", "noise"):
            raise ValueError(
                f"byzantine_mode must be 'sign_flip', 'scale' or 'noise', "
                f"got {self.byzantine_mode!r}")
        if self.byzantine_scale <= 0:
            raise ValueError(
                f"byzantine_scale must be > 0, got {self.byzantine_scale}")
        if self.score_clip < 0:
            raise ValueError(
                f"score_clip must be >= 0 (0 disables the clamp), "
                f"got {self.score_clip}")
        if self.u_zclip < 0:
            raise ValueError(
                f"u_zclip must be >= 0 (0 disables the absolute-distance "
                f"containment), got {self.u_zclip}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.global_period < 1:
            raise ValueError(
                f"global_period must be >= 1, got {self.global_period}")
        if self.groups > self.cap:
            raise ValueError(
                f"groups={self.groups} exceeds the worker capacity "
                f"{self.cap} — a rack needs at least one slot")
        if self.hierarchical and self.comm_mode != "fused":
            raise ValueError(
                "hierarchical averaging (groups > 1 or global_period > 1) "
                "requires comm_mode='fused': the group sync reuses the "
                "batched scoring + event-order-equivalent reduction, and "
                "the sequential backend's serial master dependency has no "
                "per-rack meaning")
        if self.hierarchical and self.staleness:
            raise ValueError(
                "hierarchical averaging does not compose with staleness=1 "
                "(delayed averaging references the previous global master; "
                "under a hierarchy the workers' sync target is their "
                "sub-master, which has no one-round-stale snapshot)")
        if self.membership_scenario not in MEMBERSHIP_SCENARIOS:
            raise ValueError(
                f"membership_scenario must be one of {MEMBERSHIP_SCENARIOS},"
                f" got {self.membership_scenario!r}")
        if self.membership_scenario == "plan" and not self.membership_plan:
            raise ValueError(
                "membership_scenario='plan' needs a non-empty "
                "membership_plan of (round, k) steps")
        for step in self.membership_plan:
            r, k = step
            if r < 0 or not 1 <= k <= self.cap:
                raise ValueError(
                    f"membership_plan step {step}: need round >= 0 and "
                    f"1 <= k <= capacity ({self.cap})")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adahessian"  # sgd | momentum | adam | adahessian
    lr: float = 0.01
    momentum: float = 0.5
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    hutchinson_samples: int = 1
    spatial_block: int = 128   # spatial-averaging block on last dim
    hessian_power: float = 1.0
    # Mirrored for config parity; no code path reads it (as in the
    # reference package).
    hessian_every: int = 1


ARCH_ALIASES = {"paper-cnn": "paper_cnn"}
PORTED_ARCHS = ("paper_cnn", "qwen3_4b", "stablelm_3b", "h2o_danube_1_8b",
                "mixtral_8x22b", "llama4_scout_17b_a16e",
                "moonshot_v1_16b_a3b", "qwen2_vl_7b",
                "seamless_m4t_large_v2")


def normalize_arch(arch: str) -> str:
    return ARCH_ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """``CONFIG`` (or ``SMOKE``) of a ported architecture; every other
    architecture raises ``NotImplementedError`` naming itself."""
    name = normalize_arch(arch)
    if name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet (ported: "
            f"{', '.join(PORTED_ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.CONFIG

