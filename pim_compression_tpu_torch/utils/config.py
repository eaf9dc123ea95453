"""The port's codec configuration.

``TorchCodecConfig`` is the reference ``CodecConfig`` with the port's
engines and a device. The codec has no weights: this config is the only
state it carries, so ``from_reference`` is how a reference setup moves over.
"""

from __future__ import annotations

import dataclasses

from pim_compression_tpu.utils.config import CodecConfig

ENGINES = ("cuda", "torch", "native", "oracle")

# Reference engine -> port engine. The Pallas kernels become the Hopper
# kernels, whose plain PyTorch versions (the "torch" engine) give the same
# stream. The portable XLA engine emits another stream and has no port yet.
_FROM_REFERENCE_ENGINE = {
    "pallas": "cuda",
    "native": "native",
    "oracle": "oracle",
}


@dataclasses.dataclass(frozen=True)
class TorchCodecConfig(CodecConfig):
    """Knobs for the port's codec paths.

    engine: "cuda" (hand-written Hopper kernels), "torch" (plain PyTorch on
        CPU or GPU), "native" (C++ host codec), "oracle" (pure Python).
    device: a ``torch.device`` or device string; None means ``cuda:0`` for
        the "cuda" engine and the CPU for "torch". Host engines ignore it.
    Every other field keeps the reference's meaning and checks.
    """

    engine: str = "cuda"
    device: "torch.device | str | None" = None

    def __post_init__(self) -> None:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        # The reference checks every other field; give it an engine it knows.
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(CodecConfig)}
        CodecConfig(**{**fields, "engine": "native"})

    @classmethod
    def from_reference(cls, cfg: CodecConfig, device=None) -> "TorchCodecConfig":
        """Map a reference config onto the port (pallas -> cuda).

        Raises ``ValueError`` for the reference's ``xla`` engine: the port
        has nothing that emits its stream until the portable engine is
        ported (ROADMAP A item 6).
        """
        if cfg.engine not in _FROM_REFERENCE_ENGINE:
            raise ValueError(
                f"the reference's {cfg.engine!r} engine is not ported yet "
                "(the portable engine, ROADMAP A item 6)"
            )
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(CodecConfig)}
        fields["engine"] = _FROM_REFERENCE_ENGINE[cfg.engine]
        return cls(**fields, device=device)
