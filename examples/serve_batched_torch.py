"""Continuous-batching serving demo on the PyTorch port's serve runtime.

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch recurrentgemma-2b]
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The counterpart of ``examples/serve_batched.py`` on ``repro_torch.serve``:
streams requests from the paper's S1 arrival distribution into a 4-slot
continuous-batching server driving a real reduced model (fused chunked
prefill through ``flash_attention`` + mixed-age slot decode through
``flash_decode`` on the card), then prints the serving scorecard.  Runs on
the CUDA card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.transformer import RunCtx, init_params
from repro_torch.serve import (ContinuousBatchingServer, RequestStream,
                               SlotRunner, measured_cost_model)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    ctx = RunCtx(remat=False, chunk_q=16, chunk_k=16, device=str(dev))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    cache_len = 16 + args.gen
    cost = measured_cost_model(params, cfg, ctx, max_batch=4,
                               cache_len=cache_len, prompt_len=16)
    runner = SlotRunner(params, cfg, ctx, max_batch=4, cache_len=cache_len)
    stream = RequestStream(dist="S1", n_clients=4, prompt_len=16,
                           max_new_tokens=args.gen, slo_ttft_s=2.0)
    _, summary = ContinuousBatchingServer(4, cost, runner=runner).run(
        stream.generate(horizon_s=4.0))
    for k, v in summary.items():
        print(f"{k} = {v:.4f}" if isinstance(v, float) else f"{k} = {v}")


if __name__ == "__main__":
    main()
