"""``python -m gossip_sim_tpu_torch`` — the gossip-sim experiment driver
(reference binary: gossip-sim, gossip_main.rs), on PyTorch/CUDA."""

import sys

from .cli import main

sys.exit(main())
