"""Entry point of ``python -m stonkgs_tpu_torch``."""

import sys

from stonkgs_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
