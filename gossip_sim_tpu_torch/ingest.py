"""Data ingestion for the port: the synthetic cluster and the zero-stake
filter (reference: gossip.rs:883-1005, 1044-1050).

Account files (YAML) and JSON-RPC sources are not ported yet (ROADMAP A5):
this module imports no ``yaml``, so it loads on machines without PyYAML.
"""

from __future__ import annotations

import logging

from .constants import LAMPORTS_PER_SOL
from .identity import pubkey_new_unique

log = logging.getLogger(__name__)


def filter_accounts(accounts: dict, filter_zero_staked: bool) -> dict:
    """Optionally drop zero-staked nodes (gossip.rs:892-894)."""
    if not filter_zero_staked:
        return dict(accounts)
    return {pk: s for pk, s in accounts.items() if s != 0}


def synthetic_accounts(num_nodes: int, rng, max_stake_sol: int = 1 << 20) -> dict:
    """Deterministic synthetic cluster: counter pubkeys + uniform stakes in
    [1, max_stake_sol * LAMPORTS_PER_SOL) — the reference test-fixture recipe
    (gossip.rs:1044-1050)."""
    max_stake = max_stake_sol * LAMPORTS_PER_SOL
    return {pubkey_new_unique(): rng.gen_range_u64(1, max_stake)
            for _ in range(num_nodes)}


def log_cluster_summary(accounts: dict) -> None:
    """(gossip.rs:914-923)"""
    staked = sum(1 for s in accounts.values() if s != 0)
    log.info("num of staked nodes in cluster: %s", staked)
    log.info("num of cluster nodes: %s", len(accounts))
    log.info("cluster stake: %s", sum(accounts.values()))
