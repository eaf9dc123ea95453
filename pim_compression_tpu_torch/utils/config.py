"""The port's codec configuration (counterpart of ``pim_compression_tpu.
utils.config``, which the port does not import).

``TorchCodecConfig`` has every field, default and check of the reference's
``CodecConfig`` with the port's engines in place of the reference's, plus a
device. The codec has no weights: this config is the only state it carries,
so ``from_reference`` is how a reference setup moves over. The presets'
table ``OPERATING_POINTS`` and ``preset_overrides`` are copied unchanged.
"""

from __future__ import annotations

import dataclasses

from pim_compression_tpu_torch.format import constants as C

ENGINES = ("cuda", "torch", "native", "oracle")

# Reference engine -> port engine. The Pallas kernels become the Hopper
# kernels, whose plain PyTorch versions (the "torch" engine) give the same
# stream. The portable XLA engine emits another stream and has no port yet.
_FROM_REFERENCE_ENGINE = {
    "pallas": "cuda",
    "native": "native",
    "oracle": "oracle",
}


# Measured operating points per block size (the analog of the reference's
# per-file best-config table, scripts/host_speedup.py:13-21). Values are
# CodecConfig field overrides; block sizes resolve to the nearest key.
# FULL-STREAM ratios on xml (spec emit over every block incl. the tail —
# validated to match device bench output to 4 decimals at 32K balanced;
# reference-bar = our bit-identical native codec at the same block size):
#   bs     bar     ratio        balanced     speed
#   8192   0.6859  0.7139       0.7073       0.7004 (cap3072 span16)
#   16384  0.7189  0.7467       0.7420       0.7275 (cap4096 span16)
#   32768  0.7408  0.7696       0.7560       0.7448 (cap5120 span16)
#   65536  0.7552  0.7639 (device-validated wide sel16 ladder, uncapped)
# Every preset stays at or above the reference bar at its size; "speed"
# buys ~3-5x fewer extension-sweep iterations (docs/sweep_stats.json,
# docs/device_kernel_attrib.json) for the ratio margin above the bar.
OPERATING_POINTS: dict[str, dict[int, dict]] = {
    "speed": {
        8192: dict(max_lag=3072, sweep_span=16),
        16384: dict(max_lag=4096, sweep_span=16),
        32768: dict(max_lag=5120, sweep_span=16),
        65536: dict(  # spans clamp to 4 at 64K (VMEM edge); 16384 sits
            # between the measured 0.747 @8192 and 0.7639 uncapped —
            # approximately at the 64K bar
            rungs=(4,), prev_k=2, sel_cap=16, sel_all=True,
            max_lag=16384, sweep_span=4,
        ),
    },
    "balanced": {
        8192: dict(max_lag=4096, sweep_span=8),
        16384: dict(max_lag=8192, sweep_span=8),
        32768: dict(max_lag=8192, sweep_span=8),
        65536: dict(  # capping costs more at 64K: 0.747 @8192 on device
            # vs 0.7639 uncapped — balanced keeps full reach there
            rungs=(4,), prev_k=2, sel_cap=16, sel_all=True,
            max_lag=0, sweep_span=4,
        ),
    },
    "ratio": {
        8192: dict(max_lag=0, sweep_span=8),
        16384: dict(max_lag=0, sweep_span=8),
        32768: dict(max_lag=0, sweep_span=8),
        65536: dict(
            rungs=(4,), prev_k=2, sel_cap=16, sel_all=True,
            max_lag=0, sweep_span=4,
        ),
    },
}


def preset_overrides(preset: str, block_size: int) -> dict:
    """CodecConfig field overrides for a named preset at a block size
    (nearest measured size wins)."""
    table = OPERATING_POINTS[preset]
    key = min(table, key=lambda k: abs(k - block_size))
    return dict(table[key])


@dataclasses.dataclass(frozen=True)
class TorchCodecConfig:
    """Knobs for the port's codec paths.

    block_size: decompressed bytes per independent block (reference default
        32 KB, max 64 KB — ``dpu_snappy.c:100``).
    batch_blocks: blocks per device dispatch.
    engine: "cuda" (hand-written Hopper kernels), "torch" (plain PyTorch on
        CPU or GPU), "native" (C++ host codec), "oracle" (pure Python).
    num_threads: host-codec thread fan-out (0 = all CPUs).
    device: see the field. Every other field keeps the reference's meaning
        and checks.
    """

    block_size: int = C.DEFAULT_BLOCK_SIZE
    batch_blocks: int = 1024
    engine: str = "cuda"
    num_threads: int = 0
    validate: bool = True
    match_window: int = 512  # pallas encoder search window (ratio/speed knob)
    coarse_window: int = 0  # long-range match reach beyond match_window (0 = off)
    # "sampled": every-8th lag at full byte resolution; "granular": ALL lags
    # via the 1/8-resolution phased-granule kernel (block_size % 256 == 0).
    coarse_mode: str = "sampled"
    # Encoder match finder. "sorted": rung-sort candidates — exact nearest
    # previous occurrence at ANY lag (whole-block window;
    # match_window/coarse_window ignored); the port takes block sizes that
    # are multiples of 128 in [256, 65536]. "sweep": the O(bs * window)
    # shifted-compare sweep bounded by match_window/coarse_window, at
    # block sizes up to 16384.
    matcher: str = "sorted"
    # Sorted-matcher rung ladder (prefix lengths searched; None = the full
    # (4, 8, 16, 32, 64)). The default is the measured speed flagship: a
    # single dense 4-byte rung + the prev-k ladder + fused select-extend
    # dominates every multi-rung config on the cycle/ratio frontier
    # (docs/perf_ledger.json; VERDICT r3 item 2 — the zero-flag CLI path
    # must hit the flagship, like the reference's published best configs,
    # host_speedup.py:13-21). More rungs buy ratio at proportional sort
    # cost - the tradeoff axis; reference analog compr_cycle_tradeoff.py.
    rungs: tuple[int, ...] | None = (4, 16)
    # Sorted-matcher candidates per position on the L=4 rung: k folds the
    # 2nd..k-th-nearest previous occurrences (iterated lag composition, no
    # extra sort — pallas_match._prev_step_kernel), worth +0.2-0.3 ratio
    # points per step up to k=4. Ignored by the sweep matcher. Default 2 =
    # the speed flagship; 4/6 are the balanced/ratio-champion points.
    # The port refuses prev_k > 1 without sel_all at bs <= 32768 (ROADMAP A item 7).
    prev_k: int = 1
    # Sorted-matcher half-density sort threshold: rungs >= this length sort
    # only even positions (~40% fewer sort ops on those rungs,
    # pallas_match._sort_rung_kernel stride=2) at a small ratio cost
    # (xml @32K full ladder spec: 0.7775 vs 0.7871 at 16). 0 = off; must
    # be > 4 so the L=4 rung stays full density. Ignored by the sweep
    # matcher. The speed axis' reference analog is the cycle/ratio
    # tradeoff (compr_cycle_tradeoff.py).
    # The port refuses it (BAD_ARGUMENT, ROADMAP A item 7).
    stride2_min: int = 0
    # Sorted-matcher select-then-extend cap (bytes): > 0 gives each prev
    # candidate only a cheap extension capped here, picks the per-position
    # winner, and fully extends the winner alone — prev_k capped passes
    # + 1 full pass instead of prev_k full passes
    # (pallas_match.sorted_match_groups(sel_cap=...)). 0 = off (every
    # candidate fully extended). Multiple of 4 in [4, 64]; only matters
    # when prev_k >= 2. Default 16 = the measured knee (sel12/sel8 lose
    # 2-4x more ratio per op saved).
    # The port refuses sel_cap without sel_all at bs <= 32768 (ROADMAP A item 7).
    sel_cap: int = 0
    # Sorted-matcher global select-then-extend (requires sel_cap): every
    # candidate array — each rung AND the prev ladder — gets only the
    # capped extension, fused in one kernel sharing a single word build;
    # the winner's full extension resumes from the capped state
    # (pallas_match._select_extend_kernel). The round-3 production mode:
    # (4,32)+prev2 runs at 2.26-2.59 c/B (was 4.40) for a 0.4-0.7
    # ratio-point cost on xml. Default on: the flagship operating point.
    sel_all: bool = False
    # Sorted-matcher per-rung sort densities (parallel to rungs; values
    # 1/2/4/8; overrides stride2_min). E.g. (1, 8) sorts the long rung at
    # 1/8 density: xml @32K (4,32)+prev2+sel16 = 0.7595 vs 0.7636 at
    # (1, 4) and 0.7702 at (1, 2). The first rung must stay density 1.
    # The port refuses any stride but 1 (ROADMAP A item 7).
    rung_strides: tuple[int, ...] | None = None
    # Sorted-matcher full-extension cap (bytes, multiple of 4 in
    # [max(sel_cap, 4), 64]): matches longer than this emit as chained
    # copies of at most ext_cap bytes. Default 48 — with `neighbor` the
    # ratio matches the uncapped flagship (xml @32K spec 0.7566 vs
    # 0.7563) while cutting a quarter of the extension rounds, the
    # data-dependent gather sweeps that dominate matcher cost on device.
    ext_cap: int = 48
    # Rung-priority selection (requires prev_k=1, sel_cap=0): the longest
    # rung with a candidate wins outright and ONE from-scratch extension
    # verifies it - no capped select sweeps. With rungs=(4,16): fewer
    # data-dependent gather sweeps than the prev2+sel16 ladder at BETTER
    # xml ratio (spec 0.8050 vs 0.7879); all corpus files stay below the
    # reference streams (docs/sweep_stats.json).
    # The port refuses rung_pick=False without sel_all at bs <= 32768 (ROADMAP A item 7).
    rung_pick: bool = True
    # Sorted-matcher candidate window (bytes, power of two dividing the
    # block size; 0 = the whole block): > 0 runs each rung's sort
    # chunk-locally, so candidates come only from the position's aligned
    # window-group. Caps the extension sweeps' chunk distance (the
    # dominant device cost, docs/device_kernel_attrib.json) and trims
    # sort stages, trading long-range matches: xml @32K spec ratio
    # 0.7879 full -> 0.7693 @16K -> 0.7419 @8K (reference bar 0.7408,
    # docs/sweep_stats.json). 0 keeps the full-block window.
    # The port refuses it (BAD_ARGUMENT, ROADMAP A item 7).
    sort_window: int = 0
    # Fold each position's left-neighbor match one byte shorter after the
    # rung/prev ladder (pallas_match.sorted_match_groups(neighbor=True)):
    # one elementwise pass, +0.7 xml ratio points @32K. Default on.
    neighbor: bool = True
    # Sorted-matcher candidate reach cap (bytes; 0 = whole block): drop
    # candidates with lag > max_lag (one elementwise select per rung,
    # BEFORE the pick/ladder folds so nearer short-rung candidates fill
    # in). Bounds the extension sweeps' chunk distance — the dominant
    # device encode cost (docs/device_kernel_attrib.json) — at a measured
    # small ratio price: xml @32K flagship 0.8050 full -> 0.8018 @16384
    # -> 0.7925 @8192 -> 0.7754 @4096 (census in docs/sweep_stats.json;
    # reference bar 0.7408). Unlike sort_window the cap is sliding (no
    # aligned-group loss) and saves no sort stages. Default -1 = AUTO,
    # resolved by ``effective_max_lag``: 8192 (the measured knee, ~2.2x
    # fewer sweep iterations) for block sizes <= 32768; 0 (full reach)
    # above — capping costs more at 64K (device: 0.747 @8192 vs 0.7639
    # uncapped; 64K reference bar 0.7552).
    max_lag: int = -1
    # Adaptive-sweep span: consecutive source chunks per gather iteration
    # in the extension/prev-step kernels (pallas_match._span_sweep).
    # Power of two in [2, 32] (clamped to 4 on the 64K wide path); span 8
    # halves flagship sweep iterations vs span 4 at ~span/4 gathers per
    # iteration; 16/32 only pay at small caps.
    # The port checks and ignores it: its match kernel has no chunk sweeps.
    sweep_span: int = 8
    # Incompressible fast path (the reference's skip heuristic,
    # snappy_compress.c:333-348, lifted to whole blocks): host triage
    # diverts near-random blocks (zero sampled duplicate 4-grams AND
    # near-maximal byte entropy — conservative: snappy cannot compress a
    # block with no repeated 4-gram) to raw literal frames with ZERO device
    # work. Text corpora are never diverted (their streams are unchanged).
    raw_triage: bool = True
    # On-device encode verification (the reference harness's cmp check,
    # snappy/Makefile:54-60, moved onto the chip): decode every freshly
    # encoded batch with the production decoder ON DEVICE and compare
    # against the input blocks; any mismatch or decoder error flag raises
    # SnappyError before assembly. Costs one decode pass per batch.
    verify: bool = False
    # Device-batch pipelining: up to this many batches in flight; h2d+kernel
    # of batch i+1 overlap d2h of batch i. <=1 = fully synchronous batches
    # (exact per-phase timing attribution, the reference's phase taxonomy).
    # The port ignores it: batches run one after another (ROADMAP A item 5).
    pipeline_depth: int = 2
    # When True, engine="pallas" raises instead of silently falling back to
    # the xla kernels for block sizes beyond the pallas envelope.
    # The port ignores it: it never falls back, it raises BAD_ARGUMENT.
    strict_engine: bool = False
    # Devices in the 1-D block mesh (None = all local devices). The scaling
    # sweep's analog of the reference's NR_DPUS axis
    # (snappy/scripts/asplos21/dpu_tasklet_tradeoff.py:10).
    # The port ignores it: it runs on one device (ROADMAP A item 8).
    mesh_devices: int | None = None
    # The port's device: a torch.device or device string; None means cuda:0
    # for the "cuda" engine and the CPU for "torch". Host engines ignore it.
    device: "torch.device | str | None" = None

    @property
    def effective_max_lag(self) -> int:
        """-1 (auto) resolves per block size: the measured 8192 knee up
        to 32 K; full reach above (see the max_lag field comment)."""
        if self.max_lag >= 0:
            return self.max_lag
        return 8192 if self.block_size <= 32768 else 0

    @property
    def effective_rung_pick(self) -> bool:
        """rung_pick applies only to the plain single-candidate ladder:
        setting prev_k > 1 or sel_cap > 0 opts into the select ladder and
        auto-disables it (no error - the knobs compose by priority)."""
        return self.rung_pick and self.prev_k == 1 and not self.sel_cap

    def __post_init__(self) -> None:
        if not 0 < self.block_size <= C.MAX_BLOCK_SIZE:
            raise ValueError(f"block_size must be in (0, {C.MAX_BLOCK_SIZE}]")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.coarse_mode not in ("sampled", "granular"):
            raise ValueError(f"unknown coarse_mode {self.coarse_mode!r}")
        if self.matcher not in ("sorted", "sweep"):
            raise ValueError(f"unknown matcher {self.matcher!r}")
        if self.sort_window:
            if self.sort_window & (self.sort_window - 1):
                raise ValueError("sort_window must be a power of two")
            if self.sort_window < 512:
                raise ValueError("sort_window must be >= 512")
        if self.rungs is not None and (
            not self.rungs
            or any(r not in (4, 8, 16, 32, 64) for r in self.rungs)
            or list(self.rungs) != sorted(set(self.rungs))
        ):
            raise ValueError("rungs must be an ascending subset of (4,8,16,32,64)")
        if not 1 <= self.prev_k <= 8:
            raise ValueError("prev_k must be in [1, 8]")
        if self.stride2_min and (
            self.stride2_min <= 4 or self.stride2_min not in (8, 16, 32, 64)
        ):
            raise ValueError("stride2_min must be 0 or one of (8, 16, 32, 64)")
        if self.sel_cap and (self.sel_cap % 4 or not 4 <= self.sel_cap <= 64):
            raise ValueError("sel_cap must be 0 or a multiple of 4 in [4, 64]")
        if self.sel_all and not self.sel_cap:
            raise ValueError("sel_all requires sel_cap > 0")
        if self.rung_strides is not None:
            rungs = self.rungs or (4, 8, 16, 32, 64)
            if len(self.rung_strides) != len(rungs):
                raise ValueError("rung_strides must parallel rungs")
            if any(s not in (1, 2, 4, 8) for s in self.rung_strides):
                raise ValueError("rung strides must be 1, 2, 4 or 8")
            if self.rung_strides[0] != 1:
                raise ValueError("the first rung must stay full density")
        if self.ext_cap % 4 or not max(self.sel_cap, 4) <= self.ext_cap <= 64:
            raise ValueError(
                "ext_cap must be a multiple of 4 in [max(sel_cap, 4), 64]"
            )
        if self.max_lag < -1:
            raise ValueError(
                "max_lag must be >= 0 (0 = whole-block reach) or -1 (auto)"
            )
        if self.sweep_span & (self.sweep_span - 1) or not (
            2 <= self.sweep_span <= 32
        ):
            raise ValueError("sweep_span must be a power of two in [2, 32]")

    @classmethod
    def from_reference(cls, cfg, device=None) -> "TorchCodecConfig":
        """Map a reference ``CodecConfig`` onto the port (pallas -> cuda),
        reading its fields by name.

        Raises ``ValueError`` for the reference's ``xla`` engine: the port
        has nothing that emits its stream until the portable engine is
        ported (ROADMAP A item 6).
        """
        if cfg.engine not in _FROM_REFERENCE_ENGINE:
            raise ValueError(
                f"the reference's {cfg.engine!r} engine is not ported yet "
                "(the portable engine, ROADMAP A item 6)"
            )
        names = [f.name for f in dataclasses.fields(cls) if f.name not in ("engine", "device")]
        fields = {name: getattr(cfg, name) for name in names}
        return cls(**fields, engine=_FROM_REFERENCE_ENGINE[cfg.engine], device=device)
