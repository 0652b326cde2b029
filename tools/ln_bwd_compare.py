"""K6 (the LayerNorm backward kernel, avjepa_tpu_torch/csrc/layer_norm.cu) of
this checkout against K6 of another, or of text edits of this one's source,
on one GPU, within one run.

    python tools/ln_bwd_compare.py [--compare-root DIR] [--variants JSON]

from the root of a checkout, on a machine with a CUDA GPU; the trees, their
order and ``--variants`` are tools/tree_compare.py's (tools/ln_bwd_variants.json
holds two edits of K6's design: two blocks an SM under a 128-register bound,
and rings twice as deep). Each tree's process prints the registers, shared
memory and spills of its LayerNorm backward kernels (ptxas, from the build
log), holds its K6 against its plain version at chip_smoke's LN_TIMED shapes
(bf16) and two of its runs against each other (to the bit), and times it
there: the wrapper by CUDA events (median of chip_smoke.TIME_ROUNDS rounds)
and the K6 kernels' device time by torch.profiler, beside the bound. Writes
chiprun_out/ln_bwd_compare.json.
"""

from __future__ import annotations

from tree_compare import load_chip_smoke, main


def worker(root: str) -> dict:
    """Check and time ``root``'s K6 at LN_TIMED."""
    import torch

    from avjepa_tpu_torch.ops import layer_norm as ln

    cs = load_chip_smoke()
    resources = [f"{name}: {line}" for name, line in cs.kernel_resources("ln_bwd")]
    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = []
    for r, c in cs.LN_TIMED:
        x = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device="cuda")
        got, again = ln.layer_norm_bwd(x, w, dy), ln.layer_norm_bwd(x, w, dy)
        want = ln.layer_norm_bwd_ref(x, w, dy)
        errs = [cs._rel_err(g, v) for g, v in zip(got, want)]
        if (errs[0] > cs.LN_REL_TOL["bfloat16"] or max(errs[1:]) > cs.LN_PARAM_REL_TOL
                or not all(torch.equal(a, b) for a, b in zip(got, again))):
            raise AssertionError(f"{root}: K6 disagrees at [{r}, {c}]: {errs}, or two runs differ")
        run = lambda: ln.layer_norm_bwd(x, w, dy)  # noqa: E731
        k_min, k_ms, k_max = cs._time_rounds(run, 20)
        dev = cs._device_ms(run)
        shapes.append({
            "shape": [r, c], "ms": k_ms, "ms_min": k_min, "ms_max": k_max,
            "device_ms": sum(ms for key, ms in dev.items() if "ln_bwd" in key),
            "kernels": dev, "bound_ms": cs._bound(16 * r * c, 3 * r * c * 2 + 3 * c * 4,
                                                  cs.PEAK_F32_FLOPS)[0],
            "rel_err": errs,
        })
        del x, dy, got, again, want
    return {"card": cs.card_line(), "resources": resources, "shapes": shapes}


def report(out: dict, first: dict) -> None:
    print(f"  {out['card']}")
    for line in out["resources"]:
        print(f"  ptxas {line}")
    for s in out["shapes"]:
        r, c = s["shape"]
        print(f"  K6 bf16 [{r}, {c}]: {s['ms']:.4f} ms by events ({s['ms_min']:.4f}-"
              f"{s['ms_max']:.4f}), device {s['device_ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ms: {100 * s['bound_ms'] / s['device_ms']:.1f}% of the "
              f"bound by device time; max rel err dx {s['rel_err'][0]:.2e}")


if __name__ == "__main__":
    main(worker, report, "ln_bwd_compare", timeout=600)
