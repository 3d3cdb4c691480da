"""``write-accounts`` binary: snapshot mainnet vote accounts to YAML
(reference: write_accounts_main.rs).

Pulls vote accounts over JSON-RPC, optionally keeps only zero-staked nodes
(``--zero-stakes``) or filters them out (``-f``), then writes the first N as
a ``{pubkey: stake}`` YAML account file (write_accounts_main.rs:62-125).
Run as ``python -m gossip_sim_tpu_torch.write_accounts --account-file
accounts.yaml``; it needs no GPU, and no PyYAML (ingest.py).
"""

from __future__ import annotations

import argparse
import logging
import sys

from .constants import API_MAINNET_BETA, get_json_rpc_url
from .ingest import fetch_vote_accounts_rpc, write_accounts_yaml

log = logging.getLogger("gossip_sim_tpu_torch.write_accounts")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="write-accounts",
        description="write solana vote accounts to a yaml file")
    p.add_argument("--url", dest="json_rpc_url", default=API_MAINNET_BETA,
                   metavar="URL_OR_MONIKER", help="solana's json rpc url")
    p.add_argument("--num-nodes", type=int, default=(1 << 64) - 1,
                   metavar="NUMBER_OF_NODES_TO_SIMULATE",
                   help="number of nodes to simulate. default is all")
    p.add_argument("--account-file", default="", metavar="PATH",
                   help="yaml of solana accounts to write to")
    p.add_argument("--zero-stakes", action="store_true",
                   help="set if you only want zero-staked nodes")
    p.add_argument("--filter-zero-staked-nodes", "-f", action="store_true",
                   help="Filter out all zero-staked nodes")
    return p


def write_accounts(accounts: dict, num_nodes: int, account_file: str,
                   zero_stakes_only: bool) -> dict:
    """Select the first N (optionally zero-staked-only) accounts and write
    them (write_accounts_main.rs:62-125)."""
    items = list(accounts.items())
    if zero_stakes_only:
        items = [(pk, s) for pk, s in items if s == 0]
    selected = dict(items[:num_nodes])
    log.info("writing %s accounts to %s", len(selected), account_file)
    write_accounts_yaml(account_file, selected)
    return selected


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    args = build_parser().parse_args(argv)
    if not args.account_file:
        log.error("need --account-file <path> to write to")
        return 1
    url = get_json_rpc_url(args.json_rpc_url)
    log.info("json_rpc_url: %s", url)
    accounts = fetch_vote_accounts_rpc(url)
    if args.filter_zero_staked_nodes:
        accounts = {pk: s for pk, s in accounts.items() if s != 0}
    write_accounts(accounts, args.num_nodes, args.account_file,
                   args.zero_stakes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
