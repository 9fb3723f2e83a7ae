"""``python -m racon_tpu_torch.server`` — launch the resident daemon."""

import sys

from racon_tpu_torch.server.daemon import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
