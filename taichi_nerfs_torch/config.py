"""Typed configuration of the sample-gather (NGP) path.

Port of the JAX package's ``config.py``: the same frozen dataclasses with
the same fields and defaults, ``config_for_scene`` and
``deployment_model_config``, plus :func:`config_from_opts`, the counterpart
of ``opt.py:config_from_opts`` (which imports the JAX package and so cannot
serve the port).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

SQRT3 = math.sqrt(3.0)
MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Multiresolution hash grid (the reference's layout)."""

    levels: int = 16
    feature_per_level: int = 2
    log2_T: int = 19
    base_res: int = 16
    max_res: int = 1024
    # "bfloat16": the table is gathered in bf16 (fp32 master params)
    table_dtype: str = "float32"

    @property
    def log_b(self) -> float:
        return math.log(float(self.max_res) / float(self.base_res)) / float(
            self.levels - 1
        )

    @property
    def out_dim(self) -> int:
        return self.levels * self.feature_per_level


@dataclasses.dataclass(frozen=True)
class BrickGridConfig:
    """Brick-grid encoder (``ops/brick_encoder.py``): one row per cell
    holds its full 2x2x2xF corner block."""

    levels: int = 8
    feature_per_level: int = 4
    log2_rows: int = 17  # hashed-level brick rows (8F params each)
    base_res: int = 16
    max_res: int = 1024
    table_dtype: str = "float32"

    @property
    def log_b(self) -> float:
        return math.log(float(self.max_res) / float(self.base_res)) / float(
            max(self.levels - 1, 1)
        )

    @property
    def out_dim(self) -> int:
        return self.levels * self.feature_per_level


@dataclasses.dataclass(frozen=True)
class TriPlaneConfig:
    """Tri-plane encoder (``ops/triplane.py``)."""

    levels: int = 8
    feature_per_level: int = 4
    base_res: int = 16
    max_res: int = 1024

    @property
    def log_b(self) -> float:
        return math.log(float(self.max_res) / float(self.base_res)) / float(
            self.levels - 1
        )

    @property
    def out_dim(self) -> int:
        return self.levels * self.feature_per_level


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """NGP model configuration."""

    name: str = "ngp"  # model family: {"ngp", "svox"}
    scale: float = 0.5
    pos_encoder_type: str = "hash"  # {"hash", "triplane", "brick"}
    grid: HashGridConfig = HashGridConfig()
    triplane: TriPlaneConfig = TriPlaneConfig()
    brick: BrickGridConfig = BrickGridConfig()
    grid_size: int = 128
    voxel_grid_size: int = 256
    voxel_radius: float = 0.0125
    voxel_sh_degree: int = 2
    voxel_origin_sh: float = 0.0
    voxel_origin_sigma: float = 0.1
    xyz_net_width: int = 64
    xyz_net_depth: int = 1
    xyz_net_out_dim: int = 16
    rgb_net_width: int = 64
    rgb_net_depth: int = 2
    sh_degree: int = 4  # 16-dim direction encoding
    # operand dtype of the MLP matmuls (params stay fp32)
    mlp_dtype: str = "bfloat16"

    @property
    def cascades(self) -> int:
        return max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)

    @property
    def sh_dim(self) -> int:
        return (self.sh_degree) ** 2

    @property
    def pos_out_dim(self) -> int:
        if self.pos_encoder_type == "hash":
            return self.grid.out_dim
        if self.pos_encoder_type == "triplane":
            return self.triplane.out_dim
        if self.pos_encoder_type == "brick":
            return self.brick.out_dim
        raise NotImplementedError(self.pos_encoder_type)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    exp_step_factor: float = 0.0  # 1/256 when scale > 0.5
    t_threshold: float = 1e-4
    max_samples: int = MAX_SAMPLES
    # the largest per-ray sample capacity of the dense (N_rays, S) grid;
    # the trainer adapts S below it
    train_sample_cap: int = MAX_SAMPLES
    # samples marched per round in the test-time renderer
    test_chunk_samples: int = 32
    white_bg: bool = True
    random_bg: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8192
    max_steps: int = 20000
    lr: float = 1e-2
    lr_final_div: float = 30.0  # cosine decay to lr / 30
    adam_eps: float = 1e-15
    update_interval: int = 16  # density-grid refresh cadence
    warmup_steps: int = 256  # refreshes over all cells before this step
    density_decay: float = 0.95
    distortion_loss_w: float = 0.0
    ray_sampling_strategy: str = "all_images"  # {"all_images", "same_image"}
    seed: int = 23

    def density_threshold(self, max_samples: int = MAX_SAMPLES) -> float:
        return 0.01 * max_samples / SQRT3


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    render: RenderConfig = RenderConfig()
    train: TrainConfig = TrainConfig()
    root_dir: str = ""
    dataset_name: str = "nsvf"
    split: str = "train"
    downsample: float = 1.0
    exp_name: str = "exp"
    ckpt_path: Optional[str] = None
    num_devices: int = 1
    mesh_axes: Tuple[str, ...] = ("data",)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def config_for_scene(
    scale: float, pos_encoder_type: str = "brick", **kw
) -> Config:
    """The flagship configuration for a scene of half-extent ``scale``:
    the brick encoder; ``pos_encoder_type="hash"`` for the reference's
    hash-table layout."""
    max_res = 1024 if scale == 0.5 else 4096
    model = ModelConfig(
        scale=scale,
        pos_encoder_type=pos_encoder_type,
        grid=HashGridConfig(max_res=max_res),
        brick=BrickGridConfig(max_res=max_res),
    )
    exp_step_factor = 1 / 256 if scale > 0.5 else 0.0
    render = RenderConfig(
        exp_step_factor=exp_step_factor,
        white_bg=(exp_step_factor == 0.0),
    )
    return Config(model=model, render=render, **kw)


def deployment_model_config(scale: float) -> ModelConfig:
    """The reference's small deployment model."""
    return ModelConfig(
        scale=scale,
        grid=HashGridConfig(
            levels=4, feature_per_level=4, base_res=32, max_res=128, log2_T=21
        ),
        xyz_net_width=16,
        rgb_net_width=16,
        rgb_net_depth=1,
    )


def config_from_opts(hp) -> Config:
    """The :class:`Config` of parsed ``opt.get_opts`` flags, field for field
    as ``opt.py:config_from_opts`` builds it."""
    cfg = config_for_scene(
        scale=hp.scale,
        root_dir=hp.root_dir,
        dataset_name=hp.dataset_name,
        split=hp.split,
        downsample=hp.downsample,
        exp_name=hp.exp_name,
        ckpt_path=hp.ckpt_path,
    )
    if hp.deployment:
        cfg = cfg.replace(model=deployment_model_config(hp.scale))
    table_dtype = "bfloat16" if hp.half_opt else "float32"
    levels, feats = (int(x) for x in hp.brick_shape.split("x"))
    model = cfg.model.replace(
        name=hp.model_name,
        pos_encoder_type=hp.encoder_type,
        mlp_dtype="bfloat16" if hp.half_opt else cfg.model.mlp_dtype,
        grid=dataclasses.replace(cfg.model.grid, table_dtype=table_dtype),
        brick=dataclasses.replace(
            cfg.model.brick,
            table_dtype=table_dtype,
            levels=levels,
            feature_per_level=feats,
        ),
        voxel_grid_size=hp.grid_size,
        voxel_radius=hp.grid_radius,
        voxel_sh_degree=hp.sh_degree,
        voxel_origin_sh=hp.origin_sh,
        voxel_origin_sigma=hp.origin_sigma,
    )
    exp_step_factor = 1 / 256 if hp.scale > 0.5 else 0.0
    render = RenderConfig(
        exp_step_factor=exp_step_factor,
        white_bg=(exp_step_factor == 0.0),
        random_bg=hp.random_bg,
    )
    train = TrainConfig(
        batch_size=hp.batch_size,
        max_steps=hp.max_steps,
        lr=hp.lr,
        distortion_loss_w=hp.distortion_loss_w,
        ray_sampling_strategy=hp.ray_sampling_strategy,
    )
    return cfg.replace(model=model, render=render, train=train)
