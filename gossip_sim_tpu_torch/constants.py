"""Shared constants (reference: lib.rs:8-17, 88-102, push_active_set.rs:11,
received_cache.rs:21,78, gossip.rs:490)."""

# Solana native-token scale (solana_sdk::native_token::LAMPORTS_PER_SOL,
# used at push_active_set.rs:191).
LAMPORTS_PER_SOL = 1_000_000_000

# Number of stake buckets in a push active set (push_active_set.rs:11).
NUM_PUSH_ACTIVE_SET_ENTRIES = 25

# Received-cache gating / scoring constants (received_cache.rs:21,78).
MIN_NUM_UPSERTS = 20
RECEIVED_CACHE_CAPACITY = 50

# Sentinel distance for unreached nodes (the reference's u64::MAX,
# gossip.rs:490).
UNREACHED = (1 << 64) - 1

# RPC endpoints (lib.rs:8-9).
API_MAINNET_BETA = "https://api.mainnet-beta.solana.com"
API_TESTNET = "https://api.testnet.solana.com"

# Influx endpoints (lib.rs:11-12).
INFLUX_INTERNAL_METRICS = "https://internal-metrics.solana.com:8086"
INFLUX_LOCALHOST = "http://localhost:8086"

# Coverage a healed/recovering cluster must regain for the
# iterations-to-recover metric; matches the CLI's poor-coverage warning
# threshold (gossip_main.rs:408).
COVERAGE_RECOVERY_THRESHOLD = 0.95

# Histogram bounds (lib.rs:14-17).
VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS = 50
AGGREGATE_HOPS_FAIL_NODES_HISTOGRAM_UPPER_BOUND = 40.0
AGGREGATE_HOPS_MIN_INGRESS_NODES_HISTOGRAM_UPPER_BOUND = 50
STANDARD_HISTOGRAM_UPPER_BOUND = 30


def get_json_rpc_url(url: str) -> str:
    """Resolve RPC URL monikers (lib.rs:88-94)."""
    return {"m": API_MAINNET_BETA, "mainnet-beta": API_MAINNET_BETA,
            "t": API_TESTNET, "testnet": API_TESTNET}.get(url, url)


def get_influx_url(url: str) -> str:
    """Resolve Influx URL monikers (lib.rs:96-102)."""
    return {"i": INFLUX_INTERNAL_METRICS,
            "internal-metrics": INFLUX_INTERNAL_METRICS,
            "l": INFLUX_LOCALHOST, "localhost": INFLUX_LOCALHOST}.get(url, url)
