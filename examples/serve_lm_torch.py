"""Serve a small model with batched requests through prefill + decode, with
the DaeMon movement engine on the weight path: the PyTorch port's twin of
``examples/serve_lm.py``, through ``repro_torch.launch.serve``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-14b --batch 4   # on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def main():
    from repro_torch.launch.serve import serve

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--movement", default="daemon")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    r = serve(
        args.arch, reduced=True, batch=args.batch, prompt_len=args.prompt_len,
        gen_tokens=args.gen, movement=args.movement, device=args.device,
    )
    print(
        f"arch={args.arch} batch={args.batch}: prefill {r['prefill_s']*1e3:.0f} ms, "
        f"decode {r['decode_s_per_token']*1e3:.1f} ms/token, "
        f"throughput {r['tokens_per_s']:.1f} tok/s"
    )
    print("generated token matrix:", tuple(r["tokens"].shape))


if __name__ == "__main__":
    main()
