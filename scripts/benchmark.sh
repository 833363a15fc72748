#!/usr/bin/env bash
# Benchmark runner — counterpart of the reference's scripts/benchmark.sh:
# runs bench.py, captures device info, and persists a timestamped report.
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
REPORT_DIR="${REPORT_DIR:-$REPO_ROOT/benchmark_reports}"
mkdir -p "$REPORT_DIR"
STAMP="$(date +%Y%m%d_%H%M%S)"
REPORT="$REPORT_DIR/benchmark_$STAMP.txt"

{
    echo "=== fhe_jax benchmark report ==="
    echo "date: $(date -Is)"
    echo "host: $(hostname)"
    echo
    echo "--- device info ---"
    python - <<'EOF'
import jax
for d in jax.devices():
    print(f"  {d.device_kind} (platform={d.platform}, id={d.id})")
print(f"  jax {jax.__version__}")
EOF
    echo
    echo "--- bench.py ---"
    cd "$REPO_ROOT"
    python bench.py
} 2>&1 | tee "$REPORT"

echo
echo "Report saved to $REPORT"
