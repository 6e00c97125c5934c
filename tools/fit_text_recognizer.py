#!/usr/bin/env python3
"""Fit chip_smoke's phase 4 recognizer to drawn text lines on one CUDA
card, and write the fitted state to ``assets/fitted_rec.safetensors``.

A random recognizer's texts are empty or decided by near-ties, so
chip_smoke's text gates need one that reads. The fit is not
deterministic on the card (CTC's backward sums with atomics), so it is
made once and committed: chip_smoke's phases 6 and 26 load the file
and read the same weights on every run.

The recognizer starts from phase 4's seeded weights
(``SVTRRecognizer(vocab, 0.95)``, ``torch.Generator`` seed 0, CTC blank
logit +4.0) and fits lines drawn by ``chip_smoke.text_lines`` with
``cv2.putText``.

Usage (from the repository root, on a machine with a CUDA card)::

    python3 tools/fit_text_recognizer.py [--out FILE]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
# the fit: seed, lines, Adam steps, learning rate, batch
FIT_REC_SEED, FIT_REC_LINES, FIT_REC_STEPS = 21, 8192, 800
FIT_REC_LR, FIT_REC_BATCH = 1e-3, 128


def fit_recognizer(card: str, rec_state, lines,
                   device: str = "cuda") -> dict:
    """Phase 4's recognizer (seeded weights, CTC blank +4.0) fitted on the
    card to the first FIT_REC_LINES of ``lines`` (tiles, widths, texts of
    ``chip_smoke.text_lines``; the rest held out): first each backbone
    convolution's weight and bias scaled, in forward order, so that its
    output on the first 256 lines
    has unit second moment (the seeded PP-LCNetV3 shrinks a tile to
    ~1e-9 by its last stage, so its gradients start at ~1e11 and the fit
    stalls at the blank plateau), then CTC loss, Adam at FIT_REC_LR,
    FIT_REC_STEPS steps of FIT_REC_BATCH lines, every weight trained.
    Its greedy decode of 256 held-out lines is printed (not gated)."""
    import torch
    import torch.nn.functional as F

    from oar_ocr_tpu_torch.models.layers import load_weights
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset

    t0 = time.perf_counter()
    charset = default_charset()
    vocab = 2 + len(charset)
    model = load_weights(SVTRRecognizer(vocab, 0.95),
                         {k: v.clone() for k, v in rec_state.items()},
                         device=torch.device(device))
    model.requires_grad_(True)
    tiles, widths, texts = lines
    u8 = torch.from_numpy(tiles).to(device)
    cols = torch.arange(320, device=device)[None, None, :, None]
    valid = cols < torch.from_numpy(widths).to(device)[:, None, None, None]

    def x_of(idx):
        """The rec path's tile: x·2/255 − 1 inside the line, −1 past it."""
        return torch.where(valid[idx], u8[idx].float() * (2.0 / 255.0) - 1.0,
                           -1.0)

    labels = [torch.tensor([charset.index(c) + 1 for c in t]) for t in texts]

    def unit(module, args, out):
        rms = out.float().pow(2).mean().sqrt().clamp_min(1e-30)
        module.weight.mul_(1.0 / rms)
        if module.bias is not None:
            module.bias.mul_(1.0 / rms)
        return out / rms

    hooks = [m.register_forward_hook(unit) for m in model.backbone.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model.backbone(x_of(torch.arange(256, device=device)).permute(
            0, 3, 1, 2))
    for h in hooks:
        h.remove()
    opt = torch.optim.Adam(model.parameters(), lr=FIT_REC_LR)
    gen = torch.Generator().manual_seed(FIT_REC_SEED)

    def logits_of(xb):
        head = model.head
        return head.ctc_head.fc(head.ctc_encoder(model.backbone(
            xb.permute(0, 3, 1, 2))))

    for _ in range(FIT_REC_STEPS):
        idx = torch.randint(0, FIT_REC_LINES, (FIT_REC_BATCH,),
                            generator=gen)
        with torch.enable_grad():
            lp = logits_of(x_of(idx.to(device))).float().log_softmax(-1)
            tgt = torch.cat([labels[i] for i in idx.tolist()]).to(device)
            lens = torch.tensor([len(labels[i]) for i in idx.tolist()])
            t_len = torch.full((FIT_REC_BATCH,), lp.shape[1],
                               dtype=torch.int64)
            loss = F.ctc_loss(lp.transpose(0, 1), tgt, t_len, lens,
                              blank=0, zero_infinity=True)
            opt.zero_grad()
            loss.backward()
            opt.step()
    model.eval().requires_grad_(False)
    with torch.no_grad():
        ids = logits_of(x_of(torch.arange(
            FIT_REC_LINES, FIT_REC_LINES + 256, device=device))).argmax(
                -1).cpu().numpy()
    right = 0
    for row, want in zip(ids, texts[FIT_REC_LINES:]):
        keep = [int(v) for j, v in enumerate(row)
                if v != 0 and (j == 0 or v != row[j - 1])]
        right += "".join(charset[v - 1] for v in keep
                         if v - 1 < len(charset)) == want
    print(f"recognizer fitted to {FIT_REC_LINES} drawn lines (seed "
          f"{FIT_REC_SEED}, {FIT_REC_STEPS} Adam steps of {FIT_REC_BATCH}, "
          f"lr {FIT_REC_LR}) in {time.perf_counter() - t0!r} s: last loss "
          f"{float(loss.detach())!r}, held-out lines read exactly "
          f"{right} of 256  [{card}]")
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    del model, opt, u8, valid
    if device == "cuda":
        torch.cuda.empty_cache()
    return state



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fit_text_recognizer: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from safetensors.torch import save_file

    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(cs.FITTED_REC))
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    rec_state = init_state_dict(SVTRRecognizer(2 + len(default_charset()),
                                               0.95),
                                torch.Generator().manual_seed(0))
    rec_state["head.ctc_head.fc.bias"][0] += 4.0     # as phase 4's
    state = fit_recognizer(card, rec_state, cs.text_lines(
        FIT_REC_LINES + 256, FIT_REC_SEED))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in state.items()}, str(out),
              metadata={"seed": str(FIT_REC_SEED),
                        "lines": str(FIT_REC_LINES),
                        "steps": str(FIT_REC_STEPS),
                        "lr": str(FIT_REC_LR),
                        "batch": str(FIT_REC_BATCH), "card": card})
    print(f"wrote {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
