"""``python -m graphsage_tpu_torch predict ...``"""

import sys

from graphsage_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
