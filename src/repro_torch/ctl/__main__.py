"""``python -m repro_torch.ctl`` — entry point for the repro-ctl CLI."""
import sys

from repro_torch.ctl.cli import main

if __name__ == "__main__":
    sys.exit(main())
