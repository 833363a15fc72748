#!/usr/bin/env bash
# Profiling driver — counterpart of the reference's scripts/profile.sh
# (which wraps `nsys profile --trace=cuda,...`): wraps the benchmark in a
# jax.profiler trace and reports where to open it.
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
TRACE_DIR="${TRACE_DIR:-$REPO_ROOT/profile_traces/$(date +%Y%m%d_%H%M%S)}"
mkdir -p "$TRACE_DIR"

cd "$REPO_ROOT"
TRACE_DIR="$TRACE_DIR" python - <<'EOF'
import os
import jax

trace_dir = os.environ["TRACE_DIR"]
print(f"Tracing into {trace_dir} ...")
with jax.profiler.trace(trace_dir):
    import bench
    bench.main()
print("Trace complete.")
EOF

echo
echo "Trace written to: $TRACE_DIR"
echo "Open with: TensorBoard profile plugin, or convert/upload to https://ui.perfetto.dev"
