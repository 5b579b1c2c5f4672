"""Configuration dataclasses of the PyTorch port.

The port's own copy of the JAX package's ``config.py``: features, model, loss,
data, augment and train dataclasses (everything ``train_lib.args_to_config``
fills; the device-mesh layout waits for the multi-GPU slice), the
``urbansed_supervised`` / ``tiny_test`` presets, ``DCASE_CLASS_PRIOR`` and
``load_classes_from_tsv``.  Field names, defaults and
presets are the JAX package's, so a configuration means the same thing on
both sides.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

DCASE_CLASSES = (
    "Alarm_bell_ringing",
    "Blender",
    "Cat",
    "Dishes",
    "Dog",
    "Electric_shaver_toothbrush",
    "Frying",
    "Running_water",
    "Speech",
    "Vacuum_cleaner",
)

URBAN_CLASSES = (
    "air_conditioner",
    "car_horn",
    "children_playing",
    "dog_bark",
    "drilling",
    "engine_idling",
    "gun_shot",
    "jackhammer",
    "siren",
    "street_music",
)

# DCASE's class frequencies: the semi-supervised trainer adapts its
# class-wise pseudo-label thresholds toward them (``engine.adjust_threshold``).
DCASE_CLASS_PRIOR = (
    0.09915014, 0.02266289, 0.08050047, 0.13385269, 0.13456091,
    0.01534466, 0.02219075, 0.05594901, 0.41406988, 0.0217186,
)


def load_classes_from_tsv(tsv_path: str) -> Tuple[str, ...]:
    """The sorted unique non-empty ``event_label``s of a metadata TSV."""
    from .data.tsv import read_tsv

    return tuple(sorted({r["event_label"] for r in read_tsv(tsv_path)
                         if r.get("event_label") is not None}))


@dataclass(frozen=True)
class FeatureConfig:
    """Log-mel frontend parameters."""

    sample_rate: int = 16000
    n_window: int = 1024
    n_fft: int = 1024
    hop_size: int = 323
    n_mels: int = 64
    max_len_seconds: float = 10.0
    compute_log: bool = True
    noise_snr: float = 30.0

    @property
    def max_frames(self) -> int:
        return math.ceil(self.max_len_seconds * self.sample_rate / self.hop_size)

    @classmethod
    def dcase(cls) -> "FeatureConfig":
        return cls()

    @classmethod
    def urbansed(cls) -> "FeatureConfig":
        sr = 44100
        return cls(
            sample_rate=sr,
            n_window=int(0.04 * sr),
            n_fft=2048,
            hop_size=int(0.02 * sr),
            n_mels=64,
        )

    @property
    def urban_max_frames(self) -> int:
        return int(self.max_len_seconds * self.sample_rate / self.hop_size)


@dataclass(frozen=True)
class ModelConfig:
    """SEDT architecture knobs."""

    backbone: str = "resnet50"
    dilation: bool = True
    position_embedding: str = "sine"  # 'sine' | 'learned'
    hidden_dim: int = 256
    nheads: int = 8
    dim_feedforward: int = 2048
    enc_layers: int = 3
    dec_layers: int = 3
    dropout: float = 0.1
    pre_norm: bool = True
    num_classes: int = 10
    num_queries: int = 10
    aux_loss: bool = True
    dec_at: bool = False  # audio-tag query at decoder slot 0
    pooling: Optional[str] = None  # None | 'max' | 'avg' | 'attn' | 'weighted_sum'
    self_sup: bool = False
    feature_recon: bool = False
    query_shuffle: bool = False
    mask_ratio: float = 0.1
    num_patches: int = 10
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # parameters stay float32
    max_frames: int = 496
    n_mels: int = 64
    max_events: int = 20  # dense target capacity


@dataclass(frozen=True)
class LossConfig:
    """Set-criterion and matcher weights."""

    set_cost_class: float = 1.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    ce_loss_coef: float = 1.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    weak_loss_coef: float = 1.0
    weak_loss_p_coef: float = 1.0
    feature_loss_coef: float = 1.0
    eos_coef: float = 0.1
    alpha_fl: float = 0.5
    gamma_fl: float = 1.0
    epsilon: float = 0.0
    alpha: float = 100.0


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths and composition."""

    dataset_name: str = "urbansed"  # 'urbansed' | 'dcase'
    root: str = "./data"
    exp_root: str = "./exp"
    classes: Tuple[str, ...] = URBAN_CLASSES
    batch_size: int = 64
    n_weak: int = 0  # weak-labeled sub-batch size
    num_workers: int = 0
    in_memory: bool = True
    nb_files: Optional[int] = None  # subset for debugging
    max_strong_clips: Optional[int] = None  # cap on the strong (synthetic) split only

    @property
    def num_classes(self) -> int:
        return len(self.classes)


@dataclass(frozen=True)
class AugmentConfig:
    """Device-side augmentation switches."""

    mix_up_ratio: float = 0.0
    time_mask: bool = False
    freq_mask: bool = False
    freq_shift: bool = False
    gaussian_noise_snr: float = 30.0  # teacher/student pair SNR


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule."""

    lr: float = 1e-4
    lr_backbone: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 400
    epochs_ls: int = 280  # learning-stage end; fine-tune stage after
    lr_drop: int = 160
    lr_drop_gamma: float = 0.1
    adjust_lr: bool = True  # False: the LR stays at its base value
    clip_max_norm: float = 0.1
    accumulating_gradient_steps: int = 1
    accumlating_ema_steps: int = 1
    ema_decay: float = 0.9996
    seed: int = 42
    eval_interval: int = 1
    checkpoint_epochs: Optional[int] = None
    early_stopping_patience: int = 50
    early_stopping_init_wait: int = 50
    fusion_strategy: Tuple[int, ...] = (1,)
    fine_tune: bool = False
    normalize: bool = False
    focal_loss: bool = False
    info: str = "sedt"


@dataclass(frozen=True)
class SEDTConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "SEDTConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def urbansed_supervised(cls) -> "SEDTConfig":
        """The URBAN-SED supervised recipe: ResNet-50 DC5, 3+3 layers, dec_at."""
        feats = FeatureConfig.urbansed()
        return cls(
            features=feats,
            model=ModelConfig(
                enc_layers=3,
                dec_layers=3,
                num_queries=10,
                num_classes=10,
                dec_at=True,
                max_frames=feats.urban_max_frames,
                n_mels=feats.n_mels,
            ),
            data=DataConfig(dataset_name="urbansed", classes=URBAN_CLASSES, batch_size=64),
            train=TrainConfig(epochs=400, epochs_ls=280, lr_drop=160),
        )

    @classmethod
    def tiny_test(cls) -> "SEDTConfig":
        """Small f32 config for unit tests and smoke runs."""
        return cls(
            features=FeatureConfig(sample_rate=8000, n_window=256, n_fft=256, hop_size=128,
                                   n_mels=32, max_len_seconds=2.0),
            model=ModelConfig(
                backbone="resnet18",
                enc_layers=1,
                dec_layers=2,
                hidden_dim=64,
                nheads=4,
                dim_feedforward=128,
                num_queries=6,
                num_classes=4,
                dec_at=True,
                max_frames=128,
                n_mels=32,
                max_events=8,
                compute_dtype="float32",
            ),
            data=DataConfig(classes=URBAN_CLASSES[:4], batch_size=4),
            train=TrainConfig(epochs=2, epochs_ls=1, seed=0),
        )
