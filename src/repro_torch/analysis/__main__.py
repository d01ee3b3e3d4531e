"""``python -m repro_torch.analysis`` — see lint.py for flags."""
from repro_torch.analysis.lint import main

if __name__ == "__main__":
    raise SystemExit(main())
