"""Typed configuration tree + the configs0..configs4 milestone presets.

The reference (qinjr/SCoRe, empty mount — SURVEY.md §0) has no structured config:
hyperparameters live in argv + module constants (SURVEY.md §2.3 #16). Here every
knob is a frozen dataclass field so a config hashes cleanly into jit static args.

Preset ladder (SURVEY.md §2.4):
    configs0  GRU sequential scorer, single shared table, user side only (CCMR/CPU)
    configs1  dual-side sequence encoders + attention pooling (Taobao)
    configs2  + neighbor one-hop aggregation, per-side attention (Tmall)
    configs3  full SCoRe: cross-neighbor co-attention (all datasets)
    configs4  multi-host: row-sharded tables + all-to-all lookup exchange
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Forward-pass semantics per SURVEY.md §2.4.

    sides:     'user' = single-side (configs0); 'dual' = both towers.
    slot_agg:  how the per-slot neighbor *set* becomes one vector:
               'mean'   masked mean of neighbor embeddings        (configs0/1)
               'attn'   per-side target-aware attention           (configs2)
               'coattn' cross-neighbor co-attention, the SCoRe
                        novelty (paper §3.3)                      (configs3+)
    seq_pool:  'last' = last valid GRU state; 'attn' = attention pooling with
               the opposite target embedding as query (paper §3.4).
    """

    arch: str = "score"   # 'score' | baselines: 'mf' 'svdpp' 'pop' 'delf'
    embed_dim: int = 16
    hidden_dim: int = 32
    mlp_dims: tuple = (64, 32)
    sides: str = "dual"            # 'user' | 'dual'
    slot_agg: str = "coattn"       # 'mean' | 'attn' | 'coattn'
    seq_encoder: str = "gru"       # 'gru' | 'selfattn' (SASRec-style)
                                   #       | 'caser' (causal-CNN, Caser-style)
    seq_pool: str = "attn"         # 'last' | 'attn'
    shared_table: bool = False     # one table over users+items (configs0)
    target_aware: bool = True      # add Eu_t·ei / Ei_t·eu pre-softmax terms
    coattn_pool: str = "sum"       # 'sum' | 'mean' | 'max' relation-matrix pool
    dropout: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # bfloat16 for the perf configs

    def __post_init__(self):
        assert self.arch in ("score", "mf", "svdpp", "pop", "delf"), self.arch
        assert self.sides in ("user", "dual"), self.sides
        assert self.slot_agg in ("mean", "attn", "coattn"), self.slot_agg
        assert self.seq_encoder in ("gru", "selfattn", "caser"), \
            self.seq_encoder
        assert self.seq_pool in ("last", "attn"), self.seq_pool
        assert self.coattn_pool in ("sum", "mean", "max"), self.coattn_pool


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Shapes of the packed dataset (SURVEY.md §2.4 step 1).

    num_users/num_items are counts of *real* ids; id 0 is the padding id, so
    table row counts are num_users+1 / num_items+1.
    """

    dataset: str = "synth"
    num_users: int = 2000
    num_items: int = 4000
    num_slots: int = 10            # T: global number of time slots
    user_fanout: int = 10          # n: items per user per slot (padded)
    item_fanout: int = 10          # m: users per item per slot (padded)
    num_train_neg: int = 1         # k sampled negatives per positive (train)
    num_eval_neg: int = 100        # N eval negatives per positive (paper §4.2)
    # How train negatives are drawn:
    #   'uniform'  k iid uniform item ids per positive (the reference's
    #              protocol; their histories are gathered per negative)
    #   'inbatch'  k batch-axis rolls of the positives — the negative item
    #              side reuses the positives' already-embedded history
    #              tensors, adding ZERO embedding-row gathers/scatter-adds
    #              (the dominant step cost in the profiles taken).
    #              Negatives are popularity-distributed (in-batch sampling's
    #              usual bias); quality-gated vs 'uniform' before use.
    #              Measured -0.10 val AUC (the bias) — use 'inbatch_iw'
    #              instead.
    #   'inbatch_iw'  'inbatch' + importance weights on the negative BCE
    #              terms: w_j = uniform(j)/q(j) = num_events/(num_items *
    #              train_count_j), making the expected negative gradient
    #              equal to uniform sampling's while keeping the zero-gather
    #              speed (bce_loss is a weighted mean, so the estimator is
    #              self-normalized).
    train_neg_mode: str = "uniform"
    # Per-step on-device neighbor re-sampling (reference sampler semantics,
    # SURVEY.md §2.3 #5): prep the dataset with a WIDER fan-out than
    # user_fanout/item_fanout, and each train step draws a fresh uniform
    # subset (graph.subsample_neighbors). Off = use the prep-time sample.
    neighbor_resample: bool = False

    def __post_init__(self):
        assert self.train_neg_mode in ("uniform", "inbatch", "inbatch_iw"), \
            self.train_neg_mode


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    learning_rate: float = 1e-3
    optimizer: str = "adam"        # 'adam' | 'adamw' | 'adagrad' | 'sgd'
    lr_schedule: str = "constant"  # 'constant' | 'cosine' (+ linear warmup)
    warmup_steps: int = 0          # linear warmup from 0 over this many steps
    decay_steps: int = 0           # cosine horizon; 0 = infer from epochs
    weight_decay: float = 0.0      # decoupled decay (adamw only)
    l2_emb: float = 1e-5           # λ‖Emb‖² (paper §3.5)
    num_epochs: int = 10
    eval_every_steps: int = 200
    early_stop_patience: int = 5   # evals without val-AUC improvement
    eval_max_targets: int = 8192   # subsample for periodic val (full at test)
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    log_every_steps: int = 50
    # Stride-K table updates: embedding-table grads are computed and
    # applied only on steps with step % K == 0; dense params update every
    # step. The backward pass of a non-update step produces NO table-grad
    # scatter-adds, the largest share of the step in the profiles taken.
    # Semantics change: tables train on 1/K of the batches (subsampled, not
    # summed — a summed accumulation would still pay one scatter-add per
    # update). Quality-gated at 3 seeds before adoption
    # (scripts/table_stride_ablation.py).
    table_update_every: int = 1
    # Multiplies the optimizer's table-row updates (optax.masked scale after
    # adam). Intended compensation for stride-K's K-fold fewer table adam
    # steps: boost=K restores per-epoch table travel distance. 1.0 = off
    # (no opt-state structure change).
    table_lr_boost: float = 1.0

    def __post_init__(self):
        assert self.optimizer in ("adam", "adamw", "adagrad", "sgd"), \
            self.optimizer
        assert self.lr_schedule in ("constant", "cosine"), self.lr_schedule


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh layout (SURVEY.md §5 'Distributed communication backend').

    data_axis spans the batch; rows_axis spans embedding-table rows.
    lookup_mode:
      'local'   tables replicated, plain gather (single-chip configs0-3)
      'psum'    masked partial gather + psum over rows (simple, exact)
      'a2a'     all-to-all request/response exchange (north-star path)
    """

    data_axis: str = "data"
    rows_axis: str = "rows"
    num_data: int = 1
    num_rows: int = 1
    lookup_mode: str = "local"     # 'local' | 'psum' | 'a2a'
    # a2a per-device unique-id buffer capacity (0 = exact worst case). A
    # smaller static capacity shrinks every exchange buffer; must upper-bound
    # the per-device unique-id count (sharding.a2a_lookup docstring).
    a2a_capacity: int = 0
    # What the driver does when the a2a overflow counter fires (capacity <
    # per-device uniques => the lookup read aliased rows and every metric
    # from that step on is corrupt — SURVEY.md §7.3 item 1):
    #   'raise'  abort the run with the capacity hint (default: a long
    #            unattended configs4 run must not train on garbage forever
    #            after one log line)
    #   'warn'   print the warning and keep going (debugging/bring-up)
    overflow_action: str = "raise"

    def __post_init__(self):
        assert self.lookup_mode in ("local", "psum", "a2a"), self.lookup_mode
        assert self.overflow_action in ("warn", "raise"), self.overflow_action


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _cfg(model_kw, data_kw=None, train_kw=None, shard_kw=None) -> Config:
    return Config(
        model=ModelConfig(**model_kw),
        data=DataConfig(**(data_kw or {})),
        train=TrainConfig(**(train_kw or {})),
        sharding=ShardingConfig(**(shard_kw or {})),
    )


def configs0() -> Config:
    """GRU sequential scorer, single shared table, CCMR/CPU."""
    return _cfg(
        dict(sides="user", slot_agg="mean", seq_pool="last", shared_table=True,
             target_aware=False),
        dict(dataset="ccmr"),
    )


def configs1() -> Config:
    """Dual-side encoders + attention pooling, Taobao."""
    return _cfg(
        dict(sides="dual", slot_agg="mean", seq_pool="attn"),
        dict(dataset="taobao"),
    )


def configs2() -> Config:
    """Adds neighbor one-hop aggregation (per-side attention)."""
    return _cfg(
        dict(sides="dual", slot_agg="attn", seq_pool="attn"),
        dict(dataset="tmall"),
    )


def configs3() -> Config:
    """Full SCoRe cross-neighbor co-attention."""
    return _cfg(
        dict(sides="dual", slot_agg="coattn", seq_pool="attn", target_aware=True),
        dict(dataset="taobao"),
    )


def configs4(num_data: int = 2, num_rows: int = 4) -> Config:
    """Multi-host: row-sharded tables + all-to-all lookups."""
    c = configs3()
    return c.replace(sharding=ShardingConfig(
        num_data=num_data, num_rows=num_rows, lookup_mode="a2a"))


def _baseline(model_kw) -> Config:
    return _cfg(model_kw, dict(dataset="taobao"))


# The reference's baseline-model roster (SURVEY.md §2.3 #14, paper §4.2):
# classical MF (MF, SVD++), single-side sequential (GRU4Rec-, Caser-,
# SASRec-style), dual-side non/recurrent (DELF-, RRN-style). The sequential
# entries are flag combos of ScoreModel itself; mf/svdpp/pop/delf are
# dedicated archs in score_tpu.nn.baselines. All share the train/eval
# protocol, so `python -m score_tpu.train baseline_<name>` just works.
BASELINE_PRESETS = {
    "baseline_pop": lambda: _baseline(dict(arch="pop")),
    "baseline_mf": lambda: _baseline(dict(arch="mf")),
    "baseline_svdpp": lambda: _baseline(dict(arch="svdpp")),
    "baseline_delf": lambda: _baseline(dict(arch="delf")),
    "baseline_gru4rec": lambda: _baseline(
        dict(sides="user", slot_agg="mean", seq_pool="last",
             target_aware=False)),
    "baseline_caser": lambda: _baseline(
        dict(sides="user", slot_agg="mean", seq_encoder="caser",
             seq_pool="last", target_aware=False)),
    "baseline_sasrec": lambda: _baseline(
        dict(sides="user", slot_agg="mean", seq_encoder="selfattn",
             seq_pool="last", target_aware=False)),
    "baseline_rrn": lambda: _baseline(
        dict(sides="dual", slot_agg="mean", seq_pool="last",
             target_aware=False)),
}

PRESETS = {
    "configs0": configs0,
    "configs1": configs1,
    "configs2": configs2,
    "configs3": configs3,
    "configs4": configs4,
    **BASELINE_PRESETS,
}


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply 'section.key=value' CLI overrides, e.g. {'train.batch_size': '512'}."""
    sections = {f.name: dataclasses.asdict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    for dotted, raw in overrides.items():
        section, key = dotted.split(".", 1)
        if section not in sections or key not in sections[section]:
            raise KeyError(f"unknown config key: {dotted}")
        old = sections[section][key]
        if isinstance(old, bool):
            val = raw in ("1", "true", "True")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        elif isinstance(old, tuple):
            val = tuple(int(x) for x in raw.split(",") if x)
        else:
            val = raw
        sections[section][key] = val
    return Config(
        model=ModelConfig(**sections["model"]),
        data=DataConfig(**sections["data"]),
        train=TrainConfig(**sections["train"]),
        sharding=ShardingConfig(**sections["sharding"]),
    )
