#!/bin/bash
# Drive the interactive shell at production scale (VERDICT r4 #3):
# start the server at $1^2 with the production config, wait for
# readiness, run the scripted drag driver, then sample steady-state
# /stats for the sim/encode pipeline rates.
#   tools/shell_scale_drive.sh 2048 2 [port] [pacer_fps] [encode_duty]
set -u
SIZE=${1:-2048}
DECIM=${2:-2}
PORT=${3:-8141}
FPS=${4:-60}
DUTY=${5:-0.5}
OUT=shell_out/shell_${SIZE}
mkdir -p "$OUT"

python -m esp32_fluid_simulation_tpu.io_host.server \
    --port "$PORT" --grid "$SIZE" "$SIZE" --scaling 1 --fps "$FPS" \
    --color-dtype bfloat16 \
    --stream-decim "$DECIM" --encode-duty "$DUTY" > "$OUT/server.log" 2>&1 &
echo $! > "$OUT/server.pid"

# wait until the sim is actually stepping (the production step compiles
# first): /stats answers as soon as httpd is up, so gate on the step
# counter instead
for i in $(seq 1 150); do
    STEPS=$(curl -sf -m 5 "http://127.0.0.1:$PORT/stats" 2>/dev/null \
            | python -c 'import json,sys; print(json.load(sys.stdin)["steps"])' \
            2>/dev/null || echo 0)
    if [ "${STEPS:-0}" -ge 40 ]; then
        break
    fi
    sleep 4
done
curl -sf -m 10 "http://127.0.0.1:$PORT/stats"; echo
python tools/drive_shell.py --port "$PORT" --out "$OUT"
sleep 5
echo "steady-state stats:"
curl -sf -m 10 "http://127.0.0.1:$PORT/stats"; echo
kill "$(cat "$OUT/server.pid")" 2>/dev/null
