"""``python3 -m nerfbench``: see ``run.py``."""

import sys

from nerfbench.run import main

sys.exit(main())
