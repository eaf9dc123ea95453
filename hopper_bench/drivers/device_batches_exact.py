"""``device_batches``' closed loop, and a comparison that holds compress
answers to the configuration's plain reference stream for stream.

The window, the set-up, the metrics and ``bad_blocks`` are
``device_batches``' own. The traffic file adds ``exact_blocks``: after the
window, that many blocks (all of them where fewer were kept) are drawn from
the seed out of the kept answers, and each one's compressed bytes, cut to
its size, are compared with the stream that the configuration's plain
reference (``yardstick/sweep_ref.py``) gives for the plaintext that the
working set makes again from the seed. ``stream_mismatch_blocks`` counts
those that differ; its limit is 0. A lossless stream that is not this
configuration's (a narrower search, another parse) passes ``bad_blocks``
and fails here.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import random
import sys
import time

from hopper_bench.core import cells
from hopper_bench.yardstick import sweep_ref

base = cells.load_module(pathlib.Path(__file__).with_name("device_batches.py"), "driver")
Record = base.Record
LIMITS = {"compress": {**base.LIMITS["compress"], "stream_mismatch_blocks": 0}}


class Driver(base.Driver):
    def __init__(self, cell, seed, device, seconds):
        super().__init__(cell, seed, device, seconds)
        if self.kind not in LIMITS:
            raise ValueError(f"entry must be one of {sorted(LIMITS)}, not {self.kind!r}")
        if self.codec.get("matcher") != "sweep":
            raise ValueError("the exact comparison holds the sweep matcher's configurations")
        self.exact_blocks = int(cell.traffic["exact_blocks"])
        granular = self.codec.get("coarse_mode") == "granular"
        self.ref_knobs = (*sweep_ref.knobs(self.layout.block_size, int(self.codec["match_window"]),
                                           int(self.codec.get("coarse_window", 0)), granular), granular)

    def check(self) -> dict:
        """``device_batches``' numbers and ``stream_mismatch_blocks``, each
        with its limit; ``self.failed`` is the larger of the kept answers
        either comparison found wrong."""
        checks = super().check()
        start = time.perf_counter()
        if not self.kept_host:  # the window made no call: nothing was checked
            mismatched = self.exact_blocks
        else:
            wrong = self._mismatched()
            mismatched = len(wrong)
            self.failed = max(self.failed, len({a for a, _ in wrong}))
        checks["stream_mismatch_blocks"] = (mismatched, LIMITS["compress"]["stream_mismatch_blocks"])
        print(json.dumps({"stream_check_s": time.perf_counter() - start}), file=sys.stderr, flush=True)
        return checks

    def _mismatched(self) -> list:
        """(answer, block) of the drawn blocks whose stream is not the reference's."""
        L = self.layout
        every = [(a, k) for a in range(len(self.kept_host)) for k in range(L.batch_blocks)]
        drawn = random.Random(self.seed).sample(every, min(self.exact_blocks, len(every)))
        plains, comps, batches = [], [], {}
        for a, k in drawn:
            b, (rows, sizes, _) = self.kept_host[a]
            if b not in batches:
                batches[b] = self._plain(b)
            n = int(sizes[k])
            plains.append(batches[b][k].tobytes())
            comps.append(rows[k, :n].tobytes() if 0 <= n <= rows.shape[1] else None)
        per = max(1, math.ceil(len(plains) / max(1, min(8, os.cpu_count() or 1))))
        tasks = [(part, L.block_size, *self.ref_knobs) for part in base._chunks(plains, per)]
        want = [s for part in base._pool_map(sweep_ref.encode_task, tasks, len(plains)) for s in part]
        return [at for at, got, ref in zip(drawn, comps, want) if got != ref]
