"""Adaptive push-pull: the direction switch and the traffic rescue's hash
salts (the port's copy of the reference package's ``adaptive.py``).

``gossip_mode="adaptive"`` gates the pull phase of each origin-sim on a
carried bit (``SimState.adaptive_pull_on``).  Each round re-decides it
from the round's push coverage: the pull phase runs in the NEXT round once
``n_reached >= threshold * N``, and stops once coverage falls below
``(threshold - hysteresis) * N``.  The push phase always runs.

With concurrent traffic the bit is per value (``TrafficState.v_pull``):
a value in its pull phase sends no push candidates, and every live node
still missing it sends ``pull_fanout`` stake-weighted rescue requests
(engine/traffic.py, kernels/traffic_rescue.py), drawn and gated by counter
hashes under the salts below.

The decision widens the integer count to f64 and compares it with the
thresholds multiplied by f64(N), in this one order of operations, so that
numpy, PyTorch and the reference agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# domain-separation salts of the traffic pull-rescue hash streams
# (faults.py convention)
SALT_ADAPT_PCLASS = 0x59F111F1   # rescue peer draw: stake-class uniform
SALT_ADAPT_PMEMBER = 0x923F82A4  # rescue peer draw: within-class uniform
SALT_ADAPT_PLOSS = 0xAB1C5ED5    # per-(value, requester, peer) request loss
SALT_ADAPT_PBLOOM = 0xD807AA98   # per-(value, requester) bloom-FP event


def switch_update_arr(n_covered, num_nodes, prev_on, threshold, hysteresis):
    """The direction switch on numpy arrays or torch tensors: ``n_covered``
    integer coverage count(s), ``prev_on`` matching bool(s), ``threshold``
    and ``hysteresis`` f64 scalars, or (with tensor counts) f64 tensors of
    one value per count: a sweep lane's per row.  Returns the new bit(s),
    of the input's kind.

        up   = f64(n_covered) >= threshold * f64(N)
        down = f64(n_covered) <  (threshold - hysteresis) * f64(N)
        on'  = up ? True : (down ? False : on)
    """
    n = np.float64(num_nodes)
    if torch.is_tensor(threshold):
        # the same f64 products, elementwise on the device
        up_at = threshold * float(n)
        down_at = (threshold - hysteresis) * float(n)
    else:
        thr, hyst = np.float64(threshold), np.float64(hysteresis)
        up_at, down_at = float(thr * n), float((thr - hyst) * n)
    if torch.is_tensor(n_covered):
        cov = n_covered.to(torch.float64)
        prev = prev_on.to(device=cov.device, dtype=torch.bool)
        return torch.where(cov >= up_at, True,
                           torch.where(cov < down_at, False, prev))
    cov = np.asarray(n_covered).astype(np.float64)
    return np.where(cov >= up_at, True,
                    np.where(cov < down_at, False, prev_on))


def switch_update(n_covered: int, num_nodes: int, prev_on: bool,
                  threshold: float, hysteresis: float) -> bool:
    """Scalar twin of :func:`switch_update_arr`."""
    return bool(switch_update_arr(np.int64(n_covered), np.int64(num_nodes),
                                  np.bool_(prev_on), threshold, hysteresis))
