#!/usr/bin/env bash
# CI entry: CPU test suite (8 virtual devices for mesh tests).
#
# Default tier skips @pytest.mark.slow tests; `scripts/ci.sh --all` runs
# the full suite (about four times as long).
# Any other arguments pass through to pytest.
set -euo pipefail
cd "$(dirname "$0")/.."
if [[ "${1:-}" == "--all" ]]; then
  shift
  python -m pytest tests/ -q "$@"
else
  python -m pytest tests/ -q -m "not slow" "$@"
fi
