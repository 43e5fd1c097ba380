#!/usr/bin/env bash
# Launch script (scripts_train_SigLIP_384_stage2_all) for the PyTorch port: genhancer-train-torch on
# configs/SigLIP_384_stage2_all.yaml, one process per card under torch.distributed.run (NPROC, default
# every card nvidia-smi lists; each rank trains on cuda:LOCAL_RANK).  AE points
# at the FLUX.1-dev VAE safetensors (a missing file keeps the random init).
set -euo pipefail
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export AE=${AE:-/path/to/ae.safetensors}
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
exec python3 -m torch.distributed.run --standalone --nproc_per_node "$NPROC" \
    -m genhancer_tpu_torch.cli.train --config "$ROOT/configs/SigLIP_384_stage2_all.yaml" "$@"
