#!/usr/bin/env bash
# Chaos/crash smoke matrix for the PyTorch port (src/repro_torch): the
# counterpart of scripts/chaos_smoke.sh, leg for leg, driving only
# repro_torch modules.
#
#   scripts/chaos_smoke_torch.sh                    # on the card
#   CHAOS_DEVICE=cpu scripts/chaos_smoke_torch.sh   # on the CPU
#   CHAOS_SEEDS="7" CHAOS_DEVICE=cpu scripts/chaos_smoke_torch.sh
#
# Five legs, each a different failure domain:
#
#   writer-kill   a real SIGKILL of a *leased* durable writer process
#                 mid-stream, once per seed; then a replica takes over
#                 the stale lease (epoch bump + WAL fence + tail drain),
#                 appends as the new epoch, probes that the dead epoch
#                 is refused with nothing written, and both recovery
#                 paths (latest snapshot + WAL tail vs generation-0
#                 scratch replay) must agree bit for bit across the
#                 mixed-epoch log
#   chaos soak    seeded in-process fault plans (repro_torch.launch.chaos):
#                 WAL write/fsync faults incl. torn records, replica
#                 kills, broker stalls -- gating zero acked-op loss,
#                 typed-errors-only, availability > 0 while any replica
#                 is healthy, and recovery under fire, per seed x
#                 {disk-fault, replica-kill, mixed}
#   failover      in-process writer-loss soak per seed: crash the
#                 leased writer mid-stream; gate promotion, fencing
#                 (split-brain resurrect probe), client reroute on
#                 NotLeader, zero acked-op loss across the handoff
#   tenant soak   disk-fault plans biting the per-tenant WAL dirs of
#                 the multi-tenant service: typed-errors-only and
#                 per-tenant zero acked-op loss
#   supervised    multi-process serving: parent writer + replica child
#                 processes, SIGKILL one child, require a supervisor
#                 restart and every slot to converge to the final gen
#
# CHAOS_DEVICE (default cuda) is passed to every process as --device.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

SEEDS="${CHAOS_SEEDS:-0 1 2}"
DEV="${CHAOS_DEVICE:-cuda}"

echo "== writer-kill smoke: SIGKILL a leased writer, promote, verify (seeds: $SEEDS, device $DEV) =="
for seed in $SEEDS; do
    CRASH_DIR=$(mktemp -d)
    python -m repro_torch.launch.replica --writer-child --ha \
        --dir "$CRASH_DIR" --seed "$seed" --steps 100000 \
        --snapshot-every 16 --device "$DEV" \
        > "$CRASH_DIR/writer.log" 2>&1 &
    WRITER_PID=$!
    commits=0
    for _ in $(seq 1 600); do
        commits=$(grep -c '^gen ' "$CRASH_DIR/writer.log" 2>/dev/null || true)
        [[ "${commits:-0}" -ge 24 ]] && break
        kill -0 "$WRITER_PID" 2>/dev/null || {
            cat "$CRASH_DIR/writer.log" >&2
            echo "crash-smoke writer (seed $seed) died before being killed" >&2
            exit 1
        }
        sleep 0.1
    done
    [[ "${commits:-0}" -ge 24 ]] || {
        echo "crash-smoke writer (seed $seed) made no progress" >&2; exit 1; }
    kill -9 "$WRITER_PID" 2>/dev/null
    wait "$WRITER_PID" 2>/dev/null || true
    python -m repro_torch.launch.replica --promote-after-crash \
        --dir "$CRASH_DIR" --seed "$seed" --device "$DEV"
    python -m repro_torch.launch.replica --verify-recovery \
        --dir "$CRASH_DIR" --device "$DEV"
    rm -rf "$CRASH_DIR"
done

echo "== chaos soak: seeded fault plans x {disk-fault, replica-kill, mixed} =="
python -m repro_torch.launch.chaos --smoke --seeds "${SEEDS// /,}" \
    --profiles disk-fault,replica-kill,mixed --device "$DEV"

echo "== writer failover soak: crash the leased writer, gate promotion + fencing =="
python -m repro_torch.launch.chaos --failover --smoke \
    --seeds "${SEEDS// /,}" --device "$DEV"

echo "== tenant soak: disk faults on per-tenant WAL dirs =="
python -m repro_torch.launch.chaos --tenant-soak --smoke \
    --seeds "${SEEDS// /,}" --device "$DEV"

echo "== supervised multi-process serving: SIGKILL a replica child =="
SUP_DIR=$(mktemp -d)
python -m repro_torch.launch.replica --dir "$SUP_DIR" --supervised \
    --replicas 2 --steps 40 --chunk 24 --nv 192 --kill-child-after 3 \
    --device "$DEV" | tail -1
rm -rf "$SUP_DIR"

echo "chaos smoke OK"
