"""Data ingestion: YAML account files, Solana JSON-RPC, synthetic clusters
(reference: gossip.rs:883-1005, 1044-1050 (cluster factories),
gossip_main.rs:304-328 (YAML read), write_accounts_main.rs:118-125 (YAML
write)).

No module of the port imports ``yaml`` when it is imported: the account
file functions import PyYAML where they run.  Where PyYAML is missing,
they read and write the one shape an account file has, the flat
``pubkey: stake`` mapping that ``yaml.safe_dump(..., default_flow_style=
False)`` writes (:func:`dump_accounts_text`, :func:`parse_accounts_text`),
byte for byte as PyYAML does, and refuse any other shape.
"""

from __future__ import annotations

import json
import logging
import re
import urllib.request

from .constants import LAMPORTS_PER_SOL
from .identity import Pubkey, pubkey_new_unique

log = logging.getLogger(__name__)

_B58 = "[1-9A-HJ-NP-Za-km-z]+"
_ENTRY = re.compile(rf"(?:'({_B58})'|\"({_B58})\"|({_B58})): +(-?[0-9]+) *")
# plain scalars PyYAML's resolver would read as an int or a bool; it quotes
# such keys (a base58 key holds no '0', '.', ':' or '~')
_QUOTED = re.compile(r"[1-9][0-9_]*|yes|Yes|YES|no|No|NO|true|True|TRUE|"
                     r"false|False|FALSE|on|On|ON|off|Off|OFF")


def _key_string(pk) -> str:
    return pk.to_string() if isinstance(pk, Pubkey) else str(pk)


def dump_accounts_text(accounts: dict) -> str:
    """``{pubkey: stake}`` as the text ``yaml.safe_dump(...,
    default_flow_style=False)`` writes for it: one ``key: stake`` line per
    account in key order, a key PyYAML would read as an int or a bool in
    single quotes, ``{}`` when empty.  Raises ``ValueError`` for a key that
    is not a base58 string."""
    out = {}
    for pk, stake in accounts.items():
        key = _key_string(pk)
        if not re.fullmatch(_B58, key):
            raise ValueError(f"account key {key!r} is not a base58 pubkey")
        out[key] = int(stake)
    if not out:
        return "{}\n"
    return "".join(
        f"'{k}': {v}\n" if _QUOTED.fullmatch(k) else f"{k}: {v}\n"
        for k, v in sorted(out.items()))


def parse_accounts_text(text: str) -> dict:
    """The ``{pubkey string: stake}`` mapping of an account file in the
    shape :func:`dump_accounts_text` writes (keys plain or quoted).  Raises
    ``ValueError`` on any other shape."""
    if text.strip() in ("", "{}"):
        return {}
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        m = _ENTRY.fullmatch(line)
        if m is None:
            raise ValueError(f"account file line {n} is not a 'pubkey: "
                             f"stake' entry: {line[:80]!r}")
        out[m.group(1) or m.group(2) or m.group(3)] = int(m.group(4))
    return out


def load_accounts_yaml(path: str) -> dict:
    """Read a {pubkey_str: stake} YAML account file (gossip_main.rs:304-318),
    with PyYAML where it is installed."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        accounts = parse_accounts_text(text)
    else:
        accounts = yaml.safe_load(text) or {}
    log.info("%s accounts read in", len(accounts))
    return {Pubkey.from_string(k): int(v) for k, v in accounts.items()}


def write_accounts_yaml(path: str, accounts: dict) -> None:
    """Write {pubkey: stake} as YAML (write_accounts_main.rs:118-125), with
    PyYAML where it is installed; the same bytes either way."""
    try:
        import yaml
    except ImportError:
        text = dump_accounts_text(accounts)
    else:
        text = yaml.safe_dump({_key_string(pk): int(stake)
                               for pk, stake in accounts.items()},
                              default_flow_style=False)
    with open(path, "w") as f:
        f.write(text)


def fetch_vote_accounts_rpc(json_rpc_url: str, timeout: float = 30.0) -> dict:
    """Pull vote accounts via ``getVoteAccounts`` and aggregate activated
    stake per node pubkey over current + delinquent accounts
    (gossip.rs:936-967; keeps unstaked delinquents, finalized commitment)."""
    payload = {
        "jsonrpc": "2.0",
        "id": 1,
        "method": "getVoteAccounts",
        "params": [{"commitment": "finalized",
                    "keepUnstakedDelinquents": True}],
    }
    req = urllib.request.Request(
        json_rpc_url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        result = json.load(resp)["result"]
    log.info("num of vote accounts: %s",
             len(result["current"]) + len(result["delinquent"]))
    stakes: dict = {}
    for info in list(result["current"]) + list(result["delinquent"]):
        key = info["nodePubkey"]
        stakes[key] = stakes.get(key, 0) + int(info["activatedStake"])
    return {Pubkey.from_string(k): v for k, v in stakes.items()}


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
