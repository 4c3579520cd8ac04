"""Accelerator workload definitions (Table IV of the paper).

Each workload is a list of layer descriptors consumed by the systolic trace
generator (``tracegen.py``).  Layers are either convolutions or GEMMs.  The
spatial dimensions are scaled down (``SIM_SCALE``) relative to the real
networks so that a full policy-evaluation run finishes in seconds on the CPU
host while preserving the *ratios* that drive the paper's phenomena (SRAM
capacity vs. working set, reuse structure per dataflow).  The scale factor is
recorded here and in DESIGN.md §6.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

# Spatial scale-down factor applied to ifmap H/W of the real networks.
SIM_SCALE = 8


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    c_in: int
    h: int
    w: int
    c_out: int
    r: int  # filter height
    s: int  # filter width
    stride: int = 1

    @property
    def out_h(self) -> int:
        return max(1, (self.h - self.r) // self.stride + 1)

    @property
    def out_w(self) -> int:
        return max(1, (self.w - self.s) // self.stride + 1)

    @property
    def macs(self) -> int:
        return self.out_h * self.out_w * self.c_out * self.c_in * self.r * self.s

    def as_gemm(self) -> "GemmLayer":
        """im2col view: [M=OH*OW, K=Cin*R*S] x [K, N=Cout]."""
        return GemmLayer(self.name, m=self.out_h * self.out_w,
                         k=self.c_in * self.r * self.s, n=self.c_out)


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    name: str
    m: int
    k: int
    n: int

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    def as_gemm(self) -> "GemmLayer":
        return self


def _s(x: int) -> int:
    # Scale down large spatial maps; never below 13 (the channel dims, which
    # drive SRAM-filtered reuse at the LLC, are kept exact).
    return max(min(x, 13), x // SIM_SCALE)


def tiny_yolo() -> List[ConvLayer]:
    """Tiny-YOLO v2: 9 conv layers, 416x416 input (scaled)."""
    dims = [
        (3, 416, 16), (16, 208, 32), (32, 104, 64), (64, 52, 128),
        (128, 26, 256), (256, 13, 512), (512, 13, 1024), (1024, 13, 512),
    ]
    layers = [ConvLayer(f"conv{i+1}", c, _s(hw), _s(hw), k, 3, 3)
              for i, (c, hw, k) in enumerate(dims)]
    layers.append(ConvLayer("conv9", 512, _s(13) + 2, _s(13) + 2, 125, 1, 1))
    return layers


def googlenet() -> List[ConvLayer]:
    """GoogLeNet: stem + representative inception branches (subset)."""
    layers = [
        ConvLayer("stem7x7", 3, _s(224), _s(224), 64, 7, 7, stride=2),
        ConvLayer("stem3x3", 64, _s(56), _s(56), 192, 3, 3),
    ]
    # inception modules (3a..5b): 1x1 reduce + 3x3 + 5x5 branches.
    incep = [
        ("3a", 192, 28, (64, 96, 128, 16, 32)),
        ("3b", 256, 28, (128, 128, 192, 32, 96)),
        ("4a", 480, 14, (192, 96, 208, 16, 48)),
        ("4c", 512, 14, (128, 128, 256, 24, 64)),
        ("4e", 528, 14, (256, 160, 320, 32, 128)),
        ("5b", 832, 7, (384, 192, 384, 48, 128)),
    ]
    for tag, cin, hw, (b1, r3, b3, r5, b5) in incep:
        layers += [
            ConvLayer(f"i{tag}_1x1", cin, _s(hw), _s(hw), b1, 1, 1),
            ConvLayer(f"i{tag}_3x3r", cin, _s(hw), _s(hw), r3, 1, 1),
            ConvLayer(f"i{tag}_3x3", r3, _s(hw), _s(hw), b3, 3, 3),
            ConvLayer(f"i{tag}_5x5", r5, _s(hw), _s(hw), b5, 5, 5),
        ]
    return layers


def mobilenet() -> List[ConvLayer]:
    """MobileNet v1: depthwise (modelled as low-Cin conv) + pointwise pairs."""
    layers = [ConvLayer("conv1", 3, _s(224), _s(224), 32, 3, 3, stride=2)]
    chans = [(32, 64, 112), (64, 128, 56), (128, 128, 56), (128, 256, 28),
             (256, 256, 28), (256, 512, 14), (512, 512, 14), (512, 1024, 7)]
    for i, (cin, cout, hw) in enumerate(chans):
        layers.append(ConvLayer(f"dw{i}", 1, _s(hw), _s(hw), cin, 3, 3))
        layers.append(ConvLayer(f"pw{i}", cin, _s(hw), _s(hw), cout, 1, 1))
    return layers


def deepspeech2() -> List[GemmLayer]:
    """DeepSpeech2: conv frontend + bidirectional GRU layers as GEMMs."""
    t = 64  # time steps (scaled)
    layers: List[GemmLayer] = [
        GemmLayer("conv_as_gemm", m=t, k=1952, n=1280),
    ]
    for i in range(3):
        layers.append(GemmLayer(f"gru{i}_x", m=t, k=1760, n=3 * 1760 // 2))
        layers.append(GemmLayer(f"gru{i}_h", m=t, k=1760 // 2, n=3 * 1760 // 2))
    layers.append(GemmLayer("fc", m=t, k=1760, n=29 * 32))
    return layers


def faster_rcnn() -> List[ConvLayer]:
    """Faster R-CNN (VGG backbone subset + RPN head)."""
    dims = [
        (3, 600, 64), (64, 300, 128), (128, 150, 256), (256, 150, 256),
        (256, 75, 512), (512, 75, 512), (512, 37, 512), (512, 37, 512),
    ]
    layers = [ConvLayer(f"vgg{i}", c, _s(hw), _s(hw), k, 3, 3)
              for i, (c, hw, k) in enumerate(dims)]
    layers.append(ConvLayer("rpn", 512, _s(37), _s(37), 512, 3, 3))
    layers.append(ConvLayer("rpn_cls", 512, _s(37), _s(37), 18, 1, 1))
    return layers


def alphagozero() -> List[ConvLayer]:
    """AlphaGoZero: 19x19 board, 256-channel residual conv tower (subset)."""
    layers = [ConvLayer("stem", 17, 19, 19, 256, 3, 3)]
    for i in range(4):
        layers.append(ConvLayer(f"res{i}a", 256, 19, 19, 256, 3, 3))
        layers.append(ConvLayer(f"res{i}b", 256, 19, 19, 256, 3, 3))
    layers.append(ConvLayer("policy", 256, 19, 19, 2, 1, 1))
    return layers


MODELS = {
    "tiny_yolo": tiny_yolo,
    "googlenet": googlenet,
    "mobilenet": mobilenet,
    "deepspeech2": deepspeech2,
    "faster_rcnn": faster_rcnn,
    "alphagozero": alphagozero,
}


@dataclasses.dataclass(frozen=True)
class PhaseDrift:
    """Seed-controlled phase drift across inputs (ROADMAP online-LERN study).

    The trace generator emits ``period`` replicas of the layer schedule;
    replica 0 is the base workload, each later replica accumulates
    ``reorder``-many adjacent layer swaps and jitters its streamed tile-K
    dimension by up to ``tile_jitter`` — so the reuse-interval structure an
    offline-trained LERN learned from replica 0 goes progressively stale.
    """
    period: int = 4            # replicas ("inputs") in one generated trace
    reorder: float = 0.25      # adjacent layer swaps per replica, x n_layers
    tile_jitter: float = 0.25  # max fractional jitter of the tile K dim
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    """One row of Table IV."""
    name: str
    model: str
    pe_rows: int
    pe_cols: int
    sram_ifmap_kb: int
    sram_ofmap_kb: int
    sram_filter_kb: int
    dataflow: str  # "OS" | "WS" | "IS"
    drift: Optional[PhaseDrift] = None

    def layers(self):
        return MODELS[self.model]()


# Table IV — the paper's ten accelerator configurations.
CONFIGS = {
    "config1": AccelConfig("config1", "tiny_yolo", 256, 256, 6144, 6144, 6144, "OS"),
    "config2": AccelConfig("config2", "tiny_yolo", 256, 256, 6144, 6144, 6144, "WS"),
    "config3": AccelConfig("config3", "tiny_yolo", 256, 256, 64, 64, 64, "OS"),
    "config4": AccelConfig("config4", "tiny_yolo", 64, 64, 64, 64, 64, "OS"),
    "config5": AccelConfig("config5", "googlenet", 64, 64, 64, 64, 64, "OS"),
    "config6": AccelConfig("config6", "googlenet", 64, 64, 64, 64, 64, "WS"),
    "config7": AccelConfig("config7", "mobilenet", 64, 64, 64, 64, 64, "OS"),
    "config8": AccelConfig("config8", "deepspeech2", 64, 64, 64, 64, 64, "OS"),
    "config9": AccelConfig("config9", "faster_rcnn", 256, 256, 6144, 6144, 6144, "OS"),
    "config10": AccelConfig("config10", "alphagozero", 64, 64, 64, 64, 64, "OS"),
}


def with_drift(base, drift: PhaseDrift, name: Optional[str] = None) -> str:
    """Register (idempotently) a phase-drifting variant of ``base`` and
    return its config name — usable anywhere a config name is (the exp
    spec's ``config`` axis, ``sim.load_trace``, the workload registry).

    The variant shares the base family's trace-sampling ratio (``drift``
    configs are excluded from ``sim._family_k``) so results stay
    comparable against the non-drifting base."""
    cfg = CONFIGS[base] if isinstance(base, str) else base
    if name is None:
        name = (f"{cfg.name}-drift-p{drift.period}r{drift.reorder:g}"
                f"j{drift.tile_jitter:g}s{drift.seed}")
    out = dataclasses.replace(cfg, name=name, drift=drift)
    prev = CONFIGS.setdefault(name, out)
    if prev != out:
        raise ValueError(f"config name {name!r} already registered "
                         "with different contents")
    return name


def lm_gemm_layers(n_layers: int, d_model: int, n_heads: int, d_ff: int,
                   seq: int = 128, name: str = "lm") -> List[GemmLayer]:
    """Convert an assigned LM architecture into a GEMM layer stream so the
    paper's policy can be evaluated on transformer workloads too
    (DESIGN.md §4 touchpoint 1)."""
    out: List[GemmLayer] = []
    for l in range(n_layers):
        out.append(GemmLayer(f"{name}.l{l}.qkv", m=seq, k=d_model, n=3 * d_model))
        out.append(GemmLayer(f"{name}.l{l}.attn_o", m=seq, k=d_model, n=d_model))
        out.append(GemmLayer(f"{name}.l{l}.ffn_up", m=seq, k=d_model, n=d_ff))
        out.append(GemmLayer(f"{name}.l{l}.ffn_dn", m=seq, k=d_ff, n=d_model))
    return out
