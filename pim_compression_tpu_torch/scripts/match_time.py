"""Time the match kernel at the main paths' shapes and in each sort-mode config.

    python3 -m pim_compression_tpu_torch.scripts.match_time [--device cuda:0]

Runs ``csrc/match.cu`` through ``ops.hopper_match.match_blocks`` on
device-resident batches of the seeded payloads ``chip_smoke.py`` makes: one
1024-block batch at bs 32768 in the zero-flag config, one at bs 65536 in the
zero-flag config as the runtime runs it there (the ``sel_all`` ladder),
config (a) on a 1024-block batch, and configs (a)-(e) on 128 payload blocks
and the 9 hand-built ones, as ``chip_smoke.py`` phases 6, 9 and 13 do. Each
time is the mean device time of 10 back-to-back launches by CUDA events.
Writes ``build/probes/match_time.json`` and prints one JSON line.

It runs as a file too, with another checkout's package first on
``PYTHONPATH`` (``PYTHONPATH=old python3 path/to/match_time.py``), so that
two versions of the kernel are timed in one run on one card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pim_compression_tpu_torch import TorchCodecConfig
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
from pim_compression_tpu_torch.scripts import common
from pim_compression_tpu_torch.utils import streams

SEED = 20261016
BLOCKS = 1100  # the payloads' length in blocks, less 1000 bytes
BATCH = 1024
REPS = 10
# chip_smoke.py's SORT_MODES, as config fields.
SORT_MODES = {
    "a": (32768, dict(rungs=None, prev_k=4, sel_cap=16, stride2_min=16)),
    "b": (32768, dict(rungs=(4, 16), rung_pick=False, prev_k=6)),
    "c": (32768, dict(rungs=(4, 16), sort_window=8192)),
    "d": (32768, dict(rungs=(4, 32), prev_k=2, sel_cap=16, sel_all=True, rung_strides=(1, 8))),
    "e": (65536, dict(rungs=(4, 32), rung_strides=(1, 2), sort_window=16384)),
}


def _batch(payload: bytes, bs: int, n: int) -> np.ndarray:
    return np.frombuffer(payload[: n * bs], np.uint8).reshape(n, bs).copy()


def cases() -> list[tuple]:
    """(name, bs, config fields, blocks, lens) of each timed case, on the host."""
    payloads = {bs: streams.text_payload(BLOCKS * bs - 1000, SEED) for bs in (32768, 65536)}
    out = []
    for bs in (32768, 65536):
        out.append((f"{bs} zero-flag", bs, {}, _batch(payloads[bs], bs, BATCH), np.full(BATCH, bs, np.int32)))
    for name, (bs, fields) in SORT_MODES.items():
        hb, hl = streams.hand_plain_blocks(bs, SEED)
        blocks = np.concatenate([_batch(payloads[bs], bs, 128), hb])
        out.append((f"config ({name})", bs, fields, blocks, np.concatenate([np.full(128, bs, np.int32), hl])))
    a_bs, a_fields = SORT_MODES["a"]
    out.append(("config (a)", a_bs, a_fields, _batch(payloads[a_bs], a_bs, BATCH), np.full(BATCH, a_bs, np.int32)))
    return out


def time_cases(dev, todo, check=None) -> list[dict]:
    """Mean device ms of REPS launches of match_blocks on each case, and
    each case's (mlen, mlag); with ``check`` (such outputs of another
    build) each record says whether its output equals the other's."""
    records, outputs = [], []
    for k, (name, bs, fields, blocks_np, lens_np) in enumerate(todo):
        knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs, **fields))
        blocks, lens = torch.from_numpy(blocks_np).to(dev), torch.from_numpy(lens_np).to(dev)
        kept = []
        ms = common.event_seconds(lambda: kept.append(hopper_match.match_blocks(blocks, lens, **knobs)), REPS) * 1e3
        mlen, mlag = kept[0]  # sums that two versions of the kernel must share
        rec = {"case": name, "bs": bs, "blocks": len(blocks_np), "ms": ms,
               "len_sum": int(mlen.long().sum()), "lag_sum": int((mlag.long() & 0xFFFF).sum())}
        if check is not None:
            rec["equal"] = bool(torch.equal(mlen, check[k][0]) and torch.equal(mlag, check[k][1]))
        records.append(rec)
        outputs.append((mlen, mlag))
        del kept
    return records, outputs


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = cases()
    common.warm(dev)
    records, _ = time_cases(dev, todo)
    return [{"card": common.card(dev), "kernel_source": hopper_match.__file__}] + records


def main(argv=None) -> int:
    rc = common.main("match_time", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "match_time.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
