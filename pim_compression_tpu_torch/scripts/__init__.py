"""Measurement scripts of the port, run on the card.

Counterparts of the JAX package's hardware probes (``scripts/transfer_probe.py``,
``scripts/hw_probe.py``, ``scripts/emu_calibrate.py``), the match
kernel's timings (``match_time``: its cases as ``chip_smoke.py`` runs them;
``match_variants``: builds of ``csrc/match.cu`` with other constants) and
the emit kernel's (``emit_time``: the main paths' three shapes), each
runnable as

    python -m pim_compression_tpu_torch.scripts.<name> [--device cuda:N]

and exposing ``run(device) -> records``. Each writes its records as JSON to
``build/probes/<name>.json`` at the checkout root. Without a CUDA device they
raise and write nothing.
"""
