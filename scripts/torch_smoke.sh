#!/usr/bin/env bash
# Combined smoke test of the PyTorch/CUDA port (counterpart of smoke.sh):
# boots a full deployment through the port's CLI (the data-manager and the
# chat service as processes on the card) with the offline echo model and
# hash embeddings, waits for health and ingestion, runs a chat turn with
# source verification and the data API, and tears down.  Zero egress.
#
# Departure from smoke.sh: requests go through python3's urllib, not curl;
# the interpreter is $PYTHON (default python3) and the repository root is
# put on PYTHONPATH, so the script runs from any checkout.
set -euo pipefail

PYTHON=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH=$ROOT${PYTHONPATH:+:$PYTHONPATH}
WORK=$(mktemp -d)
trap '$PYTHON -m archi_tpu_torch.cli.cli_main delete -n smoke 2>/dev/null || true; rm -rf "$WORK"' EXIT
export ARCHI_TPU_DEPLOYMENTS="$WORK/deployments"

# http METHOD URL [JSON_BODY] TIMEOUT: the response body on stdout; fails
# on a refused connection or an HTTP error, as curl -sf does
http() {
  $PYTHON - "$@" <<'PY'
import sys, urllib.request
method, url, body, timeout = sys.argv[1:5]
req = urllib.request.Request(
    url, data=body.encode() if body else None, method=method,
    headers={"Content-Type": "application/json"} if body else {})
with urllib.request.urlopen(req, timeout=float(timeout)) as r:
    sys.stdout.write(r.read().decode())
PY
}

mkdir -p "$WORK/corpus"
echo "Submit jobs with the batch scheduler. The long queue allows 48h jobs." \
  > "$WORK/corpus/guide.md"

cat > "$WORK/config.yaml" <<YAML
services:
  chat:         {enabled: true, host: 127.0.0.1, port: 7871}
  data_manager: {enabled: true, host: 127.0.0.1, port: 7872}
data_manager:
  embedding_name: hash
  sources:
    local_files:
      paths: [$WORK/corpus]
YAML

echo "== create deployment =="
$PYTHON -m archi_tpu_torch.cli.cli_main create -n smoke -c "$WORK/config.yaml"

echo "== preflight: wait for health + ingestion =="
ok=""
for i in $(seq 1 90); do
  ok=$(http GET http://127.0.0.1:7872/api/ingestion/status "" 2 2>/dev/null \
       | $PYTHON -c "import json,sys; print(json.load(sys.stdin).get('status'))" \
       2>/dev/null || true)
  [ "$ok" = "done" ] && break
  sleep 2
done
[ "$ok" = "done" ] || { echo "FAIL: ingestion never finished"; exit 1; }
http GET http://127.0.0.1:7871/healthz "" 5 > /dev/null
echo "services healthy, ingestion done"

echo "== chat turn =="
http POST http://127.0.0.1:7871/api/get_chat_response \
  '{"message": "how do I submit jobs?"}' 300 | $PYTHON -c "
import json, sys
d = json.load(sys.stdin)
assert d['answer'], 'empty answer'
assert any(s['display_name'] == 'guide.md' for s in d['sources']), d['sources']
print('chat OK; sources:', [s['display_name'] for s in d['sources']])
"

echo "== data API =="
http GET http://127.0.0.1:7872/api/stats "" 5 | $PYTHON -c "
import json, sys
d = json.load(sys.stdin)
assert d['chunks'] > 0
print('stats OK:', d['chunks'], 'chunks')
"

echo "SMOKE PASSED"
