"""``python -m ray_tpu_torch`` — CLI entry (``ray`` console script parity)."""

from ray_tpu_torch.scripts.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
