"""Configuration dataclasses of the PyTorch port.

The port's own copy of the parts of the JAX package's ``config.py`` that the
evaluation path reads: features, model, loss, the data fields the eval step
uses, and the ``urbansed_supervised`` / ``tiny_test`` presets.  Field names,
defaults and presets are the JAX package's, so a configuration means the same
thing on both sides.
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
    """The dataset fields the evaluation path reads."""

    dataset_name: str = "urbansed"  # 'urbansed' | 'dcase'
    classes: Tuple[str, ...] = URBAN_CLASSES
    batch_size: int = 64

    @property
    def num_classes(self) -> int:
        return len(self.classes)


@dataclass(frozen=True)
class SEDTConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)

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
        )
