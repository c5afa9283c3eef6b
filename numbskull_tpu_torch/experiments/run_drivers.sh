#!/bin/sh
# Run the eleven experiment drivers of numbskull_tpu_torch at their full
# sizes (the JAX drivers' defaults) on the card, one process each, from
# the root of a checkout:
#
#     sh numbskull_tpu_torch/experiments/run_drivers.sh OUTDIR
#
# Each driver writes OUTDIR/<driver>.tsv and its output to
# OUTDIR/<driver>.log; the script prints each driver's wall time and
# exits non-zero if any driver failed (the others still run).
out=${1:?usage: run_drivers.sh OUTDIR}
mkdir -p "$out"
status=0
for d in micro_gather micro_gather2 micro_gather_xla degree_sweep \
         hbm_scale engine_tradeoff profile_itemgrid lattice_rates gather_rates \
         scaling multiproc_scaling; do
    start=$(date +%s)
    if python3 -m "numbskull_tpu_torch.experiments.$d" "$out/$d.tsv" \
            > "$out/$d.log" 2>&1; then
        echo "$d: ok in $(( $(date +%s) - start )) s"
    else
        echo "$d: FAILED after $(( $(date +%s) - start )) s"
        tail -n 20 "$out/$d.log"
        status=1
    fi
done
exit $status
