"""Typed configuration for dpc_tpu_torch (a copy of ``dpc_tpu/core/config.py``:
same dataclasses, same field names, same JSON round trip).

The reference spreads its configuration over argparse flags
(``dpc/main.py:27-47``, ``eval/test.py:25-48``) and a number of hardcoded
constants (k400 downsample=5 at ``dpc/main.py:293``, augmentation
magnitudes at ``dpc/main.py:116-133``, LR milestones at
``eval/test.py:94-98``...).  Here every knob lives in one frozen dataclass
tree that is serialised into the run directory as JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

import torch

from dpc_tpu_torch.core import shapes


@dataclasses.dataclass(frozen=True)
class DPCConfig:
    """Model-shape configuration for the DPC pretraining task.

    Mirrors the constructor of the reference model
    (``dpc/model_3d.py:16-44``): a video sample is ``num_seq`` blocks of
    ``seq_len`` frames at ``img_dim``² resolution; the backbone produces a
    ``last_size``² × ``feature_size`` dense embedding per block; the ConvGRU
    aggregates the first ``num_seq - pred_step`` blocks and the predictor
    autoregressively rolls out ``pred_step`` future block embeddings.
    """

    img_dim: int = 128
    num_seq: int = 8
    seq_len: int = 5
    pred_step: int = 3
    network: str = "resnet18"
    # ConvGRU aggregator (reference hardcodes these: dpc/model_3d.py:29-35)
    gru_kernel_size: int = 1
    gru_num_layers: int = 1
    gru_dropout: float = 0.1
    # "scan" (per-step loop) | "pallas" (the whole-sequence recurrence
    # kernel).  The name is kept so config.json files read the same in both
    # packages: in dpc_tpu_torch "pallas" means the hand-written CUDA
    # recurrence kernel (ops/convgru_cuda.py), taken for kernel_size 1.
    gru_impl: str = "scan"
    # Numerics
    compute_dtype: str = "float32"  # "bfloat16": autocast compute, f32 params

    @property
    def last_duration(self) -> int:
        """Temporal extent of the backbone output (stride-4 in time).

        Reference: ``dpc/model_3d.py:24``; single source of truth in
        ``core/shapes.py`` (device-free).
        """
        return shapes.last_duration(self.seq_len)

    @property
    def last_size(self) -> int:
        """Spatial extent of the backbone output (stride-32 in space).

        Reference: ``dpc/model_3d.py:25``; single source of truth in
        ``core/shapes.py`` (device-free).
        """
        return shapes.last_size(self.img_dim)

    @property
    def sq(self) -> int:
        """Number of spatial cells in the dense feature grid."""
        return self.last_size * self.last_size

    @property
    def feature_size(self) -> int:
        """Backbone embedding width (``backbone/select_backbone.py:3-21``)."""
        return backbone_feature_size(self.network)

    @property
    def context_blocks(self) -> int:
        """Blocks seen by the aggregator before prediction starts."""
        return self.num_seq - self.pred_step


def backbone_feature_size(network: str) -> int:
    """Feature width per backbone family.

    BasicBlock nets keep layer4 at 256 planes (expansion 1); Bottleneck
    nets use 256×4.  Reference: ``backbone/select_backbone.py:3-21`` and the
    layer4 planes=256 modification at ``backbone/resnet_2d3d.py:222-223``.
    """
    if network in ("resnet18", "resnet34"):
        return 256
    if network in ("resnet50", "resnet101", "resnet152", "resnet200"):
        return 1024
    raise ValueError(f"unknown backbone: {network!r}")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / input-pipeline configuration.

    Covers the reference dataset flags (``dpc/main.py:30-35``) plus its
    hardcoded behaviours (k400 downsample=5, big-frame switch at img_dim>140,
    val subsample ratio) as explicit fields.
    """

    dataset: str = "ucf101"  # ucf101 | k400 | hmdb51 | synthetic
    data_root: str = ""      # directory holding frame trees + split CSVs
    split: int = 1           # ucf101/hmdb51 official split index
    downsample: int = 3      # frame stride inside a block ("--ds")
    val_subsample: float = 0.3
    num_workers: int = 8
    worker_mode: str = "thread"  # "thread" | "process" (GIL-bound transforms)
    prefetch: int = 4            # batches the loader keeps ready ahead
    # test-split semantics: defaults reproduce the reference exactly
    # (drop short videos everywhere, eval/dataset_3d_lc.py:61-67; window
    # starts stride-only, :124).  The opt-ins evaluate short videos via a
    # padded window / add a final tail window (PARITY.md #10, #11).
    test_keep_short: bool = False
    test_tail_window: bool = False
    # synthetic-dataset knobs (CI / smoke tests without real video data)
    synthetic_num_videos: int = 32
    synthetic_video_len: int = 256


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Pretraining-loop configuration (reference ``dpc/main.py:27-47``)."""

    batch_size: int = 4          # GLOBAL batch size
    lr: float = 1e-3
    wd: float = 1e-5
    epochs: int = 10
    start_epoch: int = 0
    print_freq: int = 5
    train_what: str = "all"      # "all" | "last" (freeze backbone)
    prefix: str = "tmp"
    resume: str = ""
    pretrain: str = ""
    reset_lr: bool = False
    seed: int = 0
    # Parallelism (parallel/mesh.py): num_devices ranks in a (data, model)
    # grid, one a card; the data axis splits the batch, the model axis
    # shards the clips and the candidate pool (global negatives, the
    # sharded NCE); train/pretrain_step.check_layout refuses a layout the
    # steps cannot run before any rank starts.
    num_devices: int = 0         # 0 = all visible devices
    model_parallel: int = 1      # clip + candidate-pool sharding
    negatives: str = "local"     # "local" (= reference per-GPU semantics) | "global"
    # NCE loss implementation: "auto" is ops/nce.pick_nce_impl: on the card
    # the flash kernels for an embedding of at most FLASH_MAX_D = 512 (R18's
    # 256) and the materialised score for wider ones (R50's 1024), as an
    # H100 sweep measured them (PERF.md §6); the flash kernels
    # whenever the score would not fit an eighth of the device's memory;
    # the materialised score on the CPU.  "xla" (materialised score) /
    # "fused" (flash kernels) force a path.
    nce_impl: str = "auto"
    fused_nce: bool = False      # deprecated alias for nce_impl="fused"
    device_augment: bool = False  # crop/flip/gray/jitter inside the step
    device_augment_recipe: str = "sized_crop"  # "sized_crop" | "crop_resize"
    fold_normalize: str = "auto"  # fold Normalize into the stem conv
    cross_replica_bn: bool = False  # reference BN is per-replica (unsynced)
    remat: bool = False          # recompute the backbone in the backward
    donate: bool = True


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Finetune / linear-probe / test configuration (``eval/test.py:25-48``)."""

    num_classes: int = 101
    dropout: float = 0.5
    train_what: str = "ft"       # "ft" | "last" (linear probe)
    lr: float = 1e-3
    wd: float = 1e-3
    epochs: int = 100
    batch_size: int = 4
    print_freq: int = 5
    # LR schedule: multi-step decay with restart multiplier
    # (reference MultiStepLR_Restart_Multiplier, eval/test.py:408-420;
    # canonical sets at eval/test.py:94-98)
    lr_milestones: Sequence[int] = (60, 80, 100)
    lr_gamma: float = 0.1
    lr_repeat: int = 1
    # backbone+GRU at lr/10 for ft — the reference's *intent*
    # (eval/test.py:76-83; latent no-op there, see train/optim.py)
    backbone_lr_scale: float = 0.1
    # dense test with 4-corner+centre crops folded into the window axis
    # (the reference's dormant path, eval/dataset_3d_lc.py:98-107)
    five_crop: bool = False
    remat: bool = False          # recompute the LC forward in the backward
    device_augment: bool = False  # finetune/val crops inside the step
    fold_normalize: str = "auto"  # fold Normalize into the stem conv
    # on resume: fresh optimizer, keep params (eval/test.py:141)
    reset_lr: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The full experiment: model + data + train(+eval) in one tree."""

    model: DPCConfig = dataclasses.field(default_factory=DPCConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        ev = dict(raw.get("eval", {}))
        if "lr_milestones" in ev:  # JSON lists -> the dataclass's tuple
            ev["lr_milestones"] = tuple(ev["lr_milestones"])
        return cls(
            model=DPCConfig(**raw.get("model", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            eval=EvalConfig(**ev),
        )


def experiment_name(cfg: ExperimentConfig) -> str:
    """Stable run-directory name encoding the key hyperparameters.

    Plays the role of the reference's ``set_path`` (``dpc/main.py:325-339``)
    but the authoritative record is the serialised config, not the name.
    """
    m, d, t = cfg.model, cfg.data, cfg.train
    return (
        f"{d.dataset}-{m.img_dim}_r{m.network[6:]}_dpc-rnn_bs{t.batch_size}"
        f"_lr{t.lr}_seq{m.num_seq}_pred{m.pred_step}_len{m.seq_len}"
        f"_ds{d.downsample}_train-{t.train_what}"
    )


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def resolve_device(device: Optional[str | torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA where there is no card raises; nothing
    quietly continues on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
