"""Time the port's kernels (flash-attention K1 forward, K2 dQ, K3 dK/dV;
int8 quantize K4 and dequantize K5) on one GPU, for the
``learningorchestra_tpu_torch`` package under a given root, so that two
versions of the kernels can be compared on one card.

    python3 scripts/torch_flash_bwd_ab.py [PACKAGE_ROOT] [LABEL]

PACKAGE_ROOT (default: this repository) is the directory that holds the
``learningorchestra_tpu_torch`` package to time, e.g. an unpacked
``git archive`` of an earlier commit; its kernels are built there.  The
timing itself is ``chip_smoke.py``'s (CUDA events behind a device sleep, a
key mask with pad tails): ``_time_bwd_at`` (K1, K2, K3 in bf16, with the
forward and backward of ``scaled_dot_product_attention`` as yardsticks)
at the fine-tune shape (32, 12, 128, 64) and at (8, 12, 512, 64), and
``time_fwd_f32`` (K1 in f32 beside SDPA's f32 forward) at the serving
shape (64, 12, 512, 64); and ``time_quant_per_leaf`` over the 51
quantized leaves of a seeded BERT-base (what every version of K4/K5 has:
one ``quantize_rowwise`` / ``dequantize_rowwise`` launch per leaf as
device time and host-paced, and the wall time of ``quantize_pytree`` /
``dequantize_pytree``).  Run versions in turns in one call (A, B, B, A):
prints one JSON line per run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO
    label = sys.argv[2] if len(sys.argv) > 2 else root.name
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this script times the "
              "kernels on a GPU", file=sys.stderr)
        return 2
    # This repository's chip_smoke (the root may hold an older one), then
    # the package under test ahead of everything.
    sys.path.insert(0, str(REPO))
    import chip_smoke

    sys.path.insert(0, str(root))
    from learningorchestra_tpu_torch.kernels import build
    from learningorchestra_tpu_torch.ops import attention

    if Path(attention.__file__).resolve().parents[2] != root:
        print(f"imported {attention.__file__}, not the package under "
              f"{root}", file=sys.stderr)
        return 3
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (b, h, t, d) in (("train", (32, 12, 128, 64)),
                               ("long", (8, 12, 512, 64))):
        q, k, v, do, _ = chip_smoke._random_qkv(gen, b, h, t, t, d,
                                                torch.bfloat16, False)
        out[name] = chip_smoke._time_bwd_at(attention, (q, k, v, None, do))
    b, h, t, d = chip_smoke.PATH_SHAPE
    q, k, v, _, _ = chip_smoke._random_qkv(gen, b, h, t, t, d, torch.float32,
                                           False)
    out["serve_f32"] = chip_smoke.time_fwd_f32(attention, q, k, v)
    del q, k, v

    from learningorchestra_tpu_torch import convert
    from learningorchestra_tpu_torch.models.text import BertModel
    from learningorchestra_tpu_torch.ops import quant

    est = BertModel(seed=0, device="cuda")
    mats = []
    for _, leaf in chip_smoke._flat(convert.flax_tree(est.module)):
        if leaf.dim() >= 2 and leaf.numel() >= 4096:
            x = leaf.detach().float().reshape(-1, leaf.shape[-1]).contiguous()
            mats.append((x, *quant.quantize_rowwise(x)))
    out["quant"] = {"leaves": len(mats),
                    **chip_smoke.time_quant_per_leaf(quant, mats)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"label": label, "card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
