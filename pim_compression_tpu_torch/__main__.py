"""``python -m pim_compression_tpu_torch``: the port's CLI (see ``cli``)."""

from pim_compression_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
