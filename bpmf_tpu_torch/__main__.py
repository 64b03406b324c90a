"""``python -m bpmf_tpu_torch`` runs the command-line interface."""

import sys

from bpmf_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
