"""Entry point of ``python -m repro_torch.obs`` (``obs/cli.py``)."""
from repro_torch.obs.cli import main

if __name__ == "__main__":
    main()
