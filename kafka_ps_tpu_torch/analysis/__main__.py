"""``python -m kafka_ps_tpu_torch.analysis`` — run the psverify suite
(pscheck + threadck + lockflow + wireck) over the port."""

import sys

from kafka_ps_tpu_torch.analysis.psverify import main

if __name__ == "__main__":
    sys.exit(main())
