"""Codec cost model for compression-aware tiered staging.

Bytes crossing the slowest link dominate turnaround (the paper's core
lesson; PR 5's per-tier accounting makes the cost measurable and PR 9's
~10 Gb/s WAN ingest tier makes it painful).  This module supplies the
*codec* side of the compress-vs-raw decision: a :class:`Codec` models a
lossless detector-frame compressor as three numbers — compress
throughput, decompress throughput, and a deterministic compression
ratio — and the :class:`~repro_torch.core.collectives.CollectivePlanner`
elects, per link tier, whether shipping compressed beats shipping raw
(the bandwidth/throughput-ratio analysis of Hayot-Sasson et al.).

Everything here is deterministic and pure: ``compressed_size`` is a
closed-form function of the payload size (no RNG, no data inspection),
so simulated plans replay bit-exactly and *payload* bytes vs *wire*
bytes are separable in every report.

The identity codec (``"none"``) resolves to ``None`` everywhere, which
keeps every pre-existing code path bit-exact — the regression anchor.

This is unrelated to :mod:`repro.train.compression` (int8 gradient
quantization for the training loop); this module is about staging
wire-byte reduction.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Mapping, Optional, Union

__all__ = [
    "Codec", "CODECS", "CompressionConfig", "CompressionLike",
    "CompressionStats", "resolve_codec",
]


# ---------------------------------------------------------------------------
# codec model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Codec:
    """A lossless codec as a throughput/ratio point.

    ``compress_bw`` / ``decompress_bw`` are single-edge codec
    throughputs in bytes/s of *payload* processed; ``ratio`` is the
    deterministic payload/wire size ratio (>= 1).  Detector frames are
    sparse int data, so a cheap bitshuffle+LZ4-class lossless pass gets
    a healthy ratio at memory-bandwidth-order speeds — that operating
    point is the default (``"frame-lossless"`` below).
    """
    name: str
    compress_bw: float = float("inf")
    decompress_bw: float = float("inf")
    ratio: float = 1.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("codec name must be non-empty")
        if not (self.compress_bw > 0 and self.decompress_bw > 0):
            raise ValueError(
                f"codec throughputs must be positive, got "
                f"compress_bw={self.compress_bw} "
                f"decompress_bw={self.decompress_bw}")
        if not self.ratio >= 1.0:
            raise ValueError(f"codec ratio must be >= 1, got {self.ratio}")

    @property
    def is_identity(self) -> bool:
        """True when compression never changes a byte count."""
        return self.ratio == 1.0

    def compressed_size(self, nbytes: int) -> int:
        """Deterministic wire size of an ``nbytes`` payload (>= 1 for any
        non-empty payload: headers never vanish)."""
        if nbytes <= 0:
            return 0
        if self.is_identity:
            return int(nbytes)
        return max(1, math.ceil(nbytes / self.ratio))

    def compress_time(self, nbytes: int) -> float:
        """Seconds to compress ``nbytes`` of payload at one edge."""
        if nbytes <= 0 or self.is_identity:
            return 0.0
        return nbytes / self.compress_bw

    def decompress_time(self, nbytes: int) -> float:
        """Seconds to decompress back to ``nbytes`` of payload."""
        if nbytes <= 0 or self.is_identity:
            return 0.0
        return nbytes / self.decompress_bw


#: Registered codecs.  ``"frame-lossless"`` is the default detector-frame
#: operating point: a multithreaded bitshuffle+LZ4-class lossless pass on
#: sparse int frames — 3.2x ratio at 4 GB/s compress / 8 GB/s decompress.
#: Its election LHS (1/Cc + 1/Cd = 0.375 ns/B) sits *between* the 2 GB/s
#: cluster links (RHS 0.344 ns/B -> ship raw) and the 1.25 GB/s WAN
#: ingest tier (RHS 0.55 ns/B -> compress at source), so the per-tier
#: decision is visible on the stock ``wan_beamline`` topology.
#: ``"frame-fast"`` (lighter filter, faster, smaller ratio) crosses over
#: on 2 GB/s links too — the hierarchical-compounding point.
#: ``"frame-deep"`` (heavier entropy stage) is too slow even for the WAN
#: pipe — the raw-wins end of the sweep.
CODECS: Mapping[str, Codec] = {
    "none": Codec(name="none"),
    "frame-lossless": Codec(name="frame-lossless", compress_bw=4e9,
                            decompress_bw=8e9, ratio=3.2),
    "frame-fast": Codec(name="frame-fast", compress_bw=8e9,
                        decompress_bw=16e9, ratio=2.5),
    "frame-deep": Codec(name="frame-deep", compress_bw=0.8e9,
                        decompress_bw=2e9, ratio=4.5),
}

DEFAULT_CODEC = "frame-lossless"


# ---------------------------------------------------------------------------
# typed config (the FaultConfig / TopologyConfig pattern)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompressionConfig:
    """Declarative codec selection for typed engine configs.

    ``codec`` names a :data:`CODECS` entry; the optional overrides
    replace that codec's throughput/ratio fields (for sweeps and tests).
    ``CompressionConfig()`` / ``"none"`` is the identity — engines take
    the exact uncompressed code path.
    """
    codec: str = "none"
    compress_bw: Optional[float] = None
    decompress_bw: Optional[float] = None
    ratio: Optional[float] = None

    def __post_init__(self) -> None:
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown codec {self.codec!r}; "
                f"registered: {sorted(CODECS)}")
        # validation of override values is delegated to Codec.__post_init__
        self.build()

    def build(self) -> Optional[Codec]:
        """Resolve to a :class:`Codec`, or ``None`` for the identity."""
        base = CODECS[self.codec]
        over = {k: v for k, v in (("compress_bw", self.compress_bw),
                                  ("decompress_bw", self.decompress_bw),
                                  ("ratio", self.ratio)) if v is not None}
        codec = replace(base, **over) if over else base
        return None if codec.is_identity else codec

    def to_dict(self) -> dict:
        """JSON-ready dict (omits unset overrides)."""
        out: dict = {"codec": self.codec}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name != "codec" and v is not None:
                out[f.name] = v
        return out

    @classmethod
    def coerce(cls, value: "CompressionLike") -> "CompressionConfig":
        """Accept loose spellings: name string, mapping, Codec, config."""
        if isinstance(value, cls):
            return value
        if value is None:
            return cls()
        if isinstance(value, str):
            return cls(codec=value)
        if isinstance(value, Codec):
            if value.name in CODECS and CODECS[value.name] == value:
                return cls(codec=value.name)
            # ad-hoc codec: carry it through as overrides on its name if
            # registered, else reject (configs must stay serializable)
            if value.name in CODECS:
                return cls(codec=value.name, compress_bw=value.compress_bw,
                           decompress_bw=value.decompress_bw,
                           ratio=value.ratio)
            raise ValueError(
                f"codec {value.name!r} is not registered; add it to "
                f"repro_torch.core.compression.CODECS or pass a "
                f"CompressionConfig with overrides")
        if isinstance(value, Mapping):
            return cls(**value)
        raise TypeError(
            f"cannot coerce {type(value).__name__} to CompressionConfig")


CompressionLike = Union[None, str, Codec, CompressionConfig, Mapping]


def resolve_codec(value: CompressionLike) -> Optional[Codec]:
    """Resolve any loose compression spelling to an active :class:`Codec`
    or ``None`` (identity: the bit-exact uncompressed path)."""
    if value is None:
        return None
    if isinstance(value, Codec):
        return None if value.is_identity else value
    return CompressionConfig.coerce(value).build()


# ---------------------------------------------------------------------------
# byte/time accounting
# ---------------------------------------------------------------------------

@dataclass
class CompressionStats:
    """Accumulated codec accounting over executed plans.

    ``payload_bytes`` counts the logical bytes compression was applied
    to on elected tiers; ``wire_bytes`` the bytes that actually crossed
    those tiers.  Plans with no elected tier contribute nothing (their
    wire bytes ARE their payload bytes — see
    ``CollectivePlan.payload_tier_bytes``).
    """
    plans: int = 0
    payload_bytes: int = 0
    wire_bytes: int = 0
    compress_time: float = 0.0
    decompress_time: float = 0.0

    @property
    def saved_bytes(self) -> int:
        return self.payload_bytes - self.wire_bytes

    @property
    def wire_ratio(self) -> float:
        """payload/wire ratio actually achieved (1.0 when idle)."""
        if self.wire_bytes <= 0:
            return 1.0
        return self.payload_bytes / self.wire_bytes

    @property
    def codec_time(self) -> float:
        return self.compress_time + self.decompress_time

    def copy(self) -> "CompressionStats":
        return replace(self)

    def delta(self, since: "CompressionStats") -> "CompressionStats":
        """Stats accumulated after the ``since`` snapshot."""
        return CompressionStats(
            plans=self.plans - since.plans,
            payload_bytes=self.payload_bytes - since.payload_bytes,
            wire_bytes=self.wire_bytes - since.wire_bytes,
            compress_time=self.compress_time - since.compress_time,
            decompress_time=self.decompress_time - since.decompress_time)

    def add(self, other: "CompressionStats") -> None:
        self.plans += other.plans
        self.payload_bytes += other.payload_bytes
        self.wire_bytes += other.wire_bytes
        self.compress_time += other.compress_time
        self.decompress_time += other.decompress_time

    def to_dict(self) -> dict:
        return {
            "plans": self.plans,
            "payload_bytes": self.payload_bytes,
            "wire_bytes": self.wire_bytes,
            "saved_bytes": self.saved_bytes,
            "wire_ratio": self.wire_ratio,
            "compress_time_s": self.compress_time,
            "decompress_time_s": self.decompress_time,
        }
