"""Chaos injection tool: kill replicas of a running FT job.

The reference's analog lives in ``torchft/examples/slurm/punisher.py``
(kill_one / kill_all / kill_loop against SLURM jobs) and the lighthouse
dashboard's kill button.  This tool speaks to the lighthouse: it reads the
current quorum membership and delivers Kill RPCs to replica managers — so it
works against any deployment (local launcher, a fleet of GPU hosts) without
scheduler integration.

CLI::

    python -m torchft_tpu_torch.punisher --lighthouse host:port kill-one
    python -m torchft_tpu_torch.punisher --lighthouse host:port kill-loop --mtbf-secs 60
"""

from __future__ import annotations

import argparse
import logging
import random
import time
from typing import List, Optional

from torchft_tpu_torch.lighthouse import LighthouseClient
from torchft_tpu_torch.manager_server import ManagerClient

logger = logging.getLogger("torchft_tpu_torch.punisher")


def _members(client: LighthouseClient) -> List[dict]:
    status = client.status()
    return status.get("participants", [])


def kill_replica(address: str, msg: str = "killed by punisher") -> bool:
    try:
        mgr = ManagerClient(address, connect_timeout=10.0)
        mgr.kill(msg)
        mgr.close()
        return True
    except Exception as e:  # noqa: BLE001 — the process dying mid-rpc is success
        logger.info("kill rpc to %s ended with %s (process likely died)", address, e)
        return True


def kill_one(client: LighthouseClient, rng: random.Random) -> Optional[str]:
    members = _members(client)
    if not members:
        logger.warning("no quorum members to kill")
        return None
    victim = rng.choice(members)
    logger.info("killing %s at %s", victim["replica_id"], victim["address"])
    kill_replica(victim["address"])
    return victim["replica_id"]


def kill_all(client: LighthouseClient) -> int:
    members = _members(client)
    for m in members:
        logger.info("killing %s at %s", m["replica_id"], m["address"])
        kill_replica(m["address"])
    return len(members)


def kill_loop(
    client: LighthouseClient, mtbf_secs: float, rng: random.Random
) -> None:
    """Poisson-ish kill loop: one random replica per ~mtbf_secs
    (``punisher.py`` ``kill_loop --mtbf-secs``)."""
    while True:
        wait = rng.expovariate(1.0 / mtbf_secs)
        logger.info("next kill in %.1fs", wait)
        time.sleep(wait)
        kill_one(client, rng)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser("torchft_tpu_torch.punisher")
    parser.add_argument("--lighthouse", required=True, help="host:port")
    parser.add_argument("--seed", type=int, default=None)
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("kill-one")
    sub.add_parser("kill-all")
    loop = sub.add_parser("kill-loop")
    loop.add_argument("--mtbf-secs", type=float, default=60.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    rng = random.Random(args.seed)
    client = LighthouseClient(args.lighthouse, connect_timeout=10.0)
    if args.command == "kill-one":
        kill_one(client, rng)
    elif args.command == "kill-all":
        kill_all(client)
    elif args.command == "kill-loop":
        kill_loop(client, args.mtbf_secs, rng)


if __name__ == "__main__":
    main()
