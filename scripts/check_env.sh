#!/usr/bin/env bash
# Environment check — counterpart of the reference's scripts/install_deps.sh
# (which apt-installed CUDA 12.3).  Nothing to install for fhe_jax beyond
# JAX (with its CUDA plugin on a GPU host) and numpy; this script verifies
# the runtime prerequisites and reports what is available.
set -uo pipefail

ok=0
fail=0
note() { printf '  %-34s %s\n' "$1" "$2"; }

echo "=== fhe_jax environment check ==="

if python -c "import jax" 2>/dev/null; then
    note "jax" "$(python -c 'import jax; print(jax.__version__)')"
    note "devices" "$(python -c 'import jax; print(", ".join(f"{d.device_kind}({d.platform})" for d in jax.devices()))' 2>/dev/null || echo unavailable)"
    ok=$((ok+1))
else
    note "jax" "MISSING — install jax for your platform"; fail=$((fail+1))
fi

for mod in numpy pytest; do
    if python -c "import $mod" 2>/dev/null; then
        note "$mod" "$(python -c "import $mod; print(getattr($mod,'__version__','?'))")"
        ok=$((ok+1))
    else
        note "$mod" "MISSING"; fail=$((fail+1))
    fi
done

if command -v g++ >/dev/null; then
    note "g++ (native host lib)" "$(g++ --version | head -1)"
    ok=$((ok+1))
else
    note "g++" "missing — native/ lib unavailable, Python fallback active"
fi

if python -c "import sys; sys.path.insert(0,'.'); from fhe_jax.utils import native; sys.exit(0 if native.available() else 1)" 2>/dev/null; then
    note "native libfhecore" "loaded"
else
    note "native libfhecore" "not built (run: make -C native)"
fi

echo
echo "$ok checks passed${fail:+, $fail missing}"
exit $((fail > 0 ? 1 : 0))
