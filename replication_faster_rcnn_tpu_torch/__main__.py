"""``python -m replication_faster_rcnn_tpu_torch {train,eval,quantize,predict,
serve,bench,telemetry} ...`` — the port's command line (``cli.py``)."""

import sys

from replication_faster_rcnn_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
