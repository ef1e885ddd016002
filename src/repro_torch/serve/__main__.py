"""``python -m repro_torch.serve`` starts the pricing daemon (``daemon.main``).

Guarded, so that importing the module (as a walk over the package does)
starts nothing."""
import sys

from .daemon import main

if __name__ == "__main__":
    sys.exit(main())
