"""gossip_sim_tpu_torch — the Solana gossip protocol simulator (push,
pull, push-pull and adaptive modes, and concurrent push traffic) on
PyTorch and CUDA (NVIDIA H100).

A port of the ``gossip_sim_tpu`` package that imports nothing of it and no
JAX.  It keeps its own copies of the modules it needs and is held bit for
bit against the reference package's engine and CLI.

Layout:
  constants, identity, config, faults, ingest, rustrng   own copies
  pull, adaptive  the pull phase's hashes and tables, the direction switch
  traffic    the concurrent-traffic model: salts, outcome codes, the class
             draw, the shared active set, retirement records
  rng        threefry keys and uniforms, bit-equal to jax.random
  engine     make_cluster_tables / init_state / round_step / run_rounds;
             engine.lanes: sweep lanes (run_rounds_lanes);
             engine.traffic: init_traffic_state / traffic_round_step /
             run_traffic_rounds, and traffic lanes (run_traffic_lanes)
  kernels    hand-written CUDA kernels (csrc/) + their plain versions
  stats      GossipStats suite (gossip_stats.rs), TrafficStats
  sinks      Influx line-protocol series and sender (influx_db.rs)
  convert    carry state between the two packages as numpy arrays
  checkpoint the reference's v9 state .npz, read and written both ways
  resilience the run journal, graceful shutdown (exit 75) and the device
             supervisor
  cli        experiment harness: account sources, --test-type sweeps,
             all-origins, traffic, checkpoints and --resume
             (python -m gossip_sim_tpu_torch)
  write_accounts  the write-accounts binary
             (python -m gossip_sim_tpu_torch.write_accounts)
"""

__version__ = "0.1.0"
