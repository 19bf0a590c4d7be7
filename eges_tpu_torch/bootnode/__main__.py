"""``python -m eges_tpu_torch.bootnode`` — standalone discovery bootnode
(ref: cmd/bootnode/main.go; protocol in eges_tpu_torch/net/discovery.py).

The port's copy of ``eges_tpu/bootnode/__main__.py``, unchanged but for
its imports: it has no device."""

from __future__ import annotations

import argparse
import asyncio

from eges_tpu_torch.net.discovery import BootnodeService


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="eges-tpu-bootnode")
    p.add_argument("--addr", default="0.0.0.0")
    p.add_argument("--port", type=int, default=30301)
    args = p.parse_args(argv)

    async def run():
        svc = BootnodeService(args.addr, args.port)
        await svc.start()
        print(f"bootnode listening on {args.addr}:{args.port} (udp)",
              flush=True)
        while True:
            await asyncio.sleep(30)
            print(f"registry: {len(svc.registry)} peers", flush=True)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
