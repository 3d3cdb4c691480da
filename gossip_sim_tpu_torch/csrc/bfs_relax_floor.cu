// bfs_relax's latency floor: csrc/bfs_relax.cu built with BFS_RELAX_FLOOR,
// which compiles its kernel for an empty frontier run for a given number of
// hops and exports bfs_relax_floor_launch alone.  A measurement aid: only
// kernels/bfs_relax.py _latency_floor loads it (chip_smoke.py's
// --profile-sparse child); the engine never does.
#define BFS_RELAX_FLOOR
#include "bfs_relax.cu"
