"""Configuration dataclasses, read and written in the JAX package's JSON form.

Every field of ``deepmetv2_tpu/config.py`` is kept, so a run config written
by either package (``ckpts_syn/config.json``, ``ckpts_syn_drn/config.json``)
reads the same here.  Fields that only the JAX package's other paths use
(the mesh, the chained and resident feeds) are carried so that such a file
round-trips.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


def _tuples(v):
    """JSON lists as (nested) tuples, the dataclasses' form."""
    return tuple(_tuples(e) for e in v) if isinstance(v, list) else v


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Graph construction (reference train.py:47-48)."""

    delta_r: float = 0.4            # radius in (eta, phi)
    max_neighbors: int = 256
    self_loops: bool = True
    phi_wraparound: bool = False    # the reference's metric has no phi wrap
    # 'neighbor_list' (explicit lists capped at max_neighbors, the
    # reference's graph) or 'window' (implicit eta-sorted radius graph,
    # uncapped, through the window kernels; window_halo must cover the
    # data's sorted-order neighbour span)
    mode: str = "neighbor_list"
    window_halo: int = 128          # >= data/sorting.required_halo
    presorted: bool = False         # batches arrive already eta-sorted


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GraphMETNetwork hyperparameters (reference model/graph_met_network.py)."""

    continuous_dim: int = 8
    categorical_dim: int = 3
    hidden_dim: int = 32
    conv_depth: int = 2
    output_dim: int = 1
    pdgs: Tuple[int, ...] = (1, 2, 11, 13, 22, 130, 211)
    # 'float32' or 'bfloat16': the EdgeConv's GEMMs and window max in bf16
    # (ops/window.py:edgeconv_terms), everything else in float32
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DRNConfig:
    """DynamicReductionNetwork hyperparameters (models/drn.py)."""

    input_dim: int = 11
    hidden_dim: int = 64
    output_dim: int = 2
    k: int = 16
    und_cap: "int | None" = None
    mirror_gather: bool = False
    aggr: str = "add"
    pool_rounds: int = 2
    head: str = "polar"
    ring_knn: bool = False
    compact_pool: bool = True
    output_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class ParticleNetConfig:
    """ParticleNet hyperparameters (models/particlenet.py; weaver-core
    ``networks/example_ParticleNet.py``): the widths of each EdgeConv
    block's three 1x1 convolutions, all at ``k`` neighbours."""

    input_dim: int = 11
    k: int = 16
    conv_params: Tuple[Tuple[int, ...], ...] = ((64, 64, 64),
                                                (128, 128, 128),
                                                (256, 256, 256))
    fc: int = 256
    dropout: float = 0.1
    output_scale: float = 1.0

    @property
    def fusion(self) -> int:
        """The fusion's width by weaver's rule: the blocks' widths summed,
        rounded down to a multiple of 128, clipped to 128..1024."""
        fused = sum(w[-1] for w in self.conv_params)
        return min(max(fused // 128 * 128, 128), 1024)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW + plateau schedule (reference train.py:75-76)."""

    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    plateau_factor: float = 0.5
    plateau_patience: int = 500
    plateau_threshold: float = 0.05
    grad_clip_norm: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / batching (reference model/data_loader.py:92-111)."""

    batch_size: int = 6
    validation_split: float = 0.2
    seed: int = 42
    clip_value: float = 5000.0
    pad_fill: float = -999.0
    # padded-node capacity buckets: a batch pads to the smallest bucket
    # that holds its largest event
    node_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    eval_batch_size: int = 40            # reference evaluate.py:176
    bn_refresh_batches: int = 0
    chain_steps: int = 8
    resident_feed: bool = True
    qt_max: float = 400.0                # reference evaluate.py:111-112
    qt_bin_width: float = 10.0
    qt_hist_bins: int = 40
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    node_axis: str = "node"
    data_parallel: int = -1
    node_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    drn: DRNConfig = dataclasses.field(default_factory=DRNConfig)
    particlenet: ParticleNetConfig = dataclasses.field(
        default_factory=ParticleNetConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        """Every section of ``Config`` that ``s`` holds, built by its class
        (the field's default factory); the other keys are ignored."""
        raw = json.loads(s)
        return Config(**{
            f.name: f.default_factory(**{k: _tuples(v)
                                         for k, v in raw[f.name].items()})
            for f in dataclasses.fields(Config) if f.name in raw})
