"""``python -m repro_torch.analyze`` — the static schedule linter
(see ``repro_torch.analysis.cli`` for what gets checked)."""
from repro_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
