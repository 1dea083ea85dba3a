"""Interactive rollout of a saved agent — the port of ``cli/enjoy.py`` (the
vendored ``enjoy.py``, :39-95): load a checkpoint and watch it play a
scripted opponent, or play against it as a human, through the compat
``SimpleOthelloEnv`` (``core.state.step`` underneath: on 8x8 one launch of
the ply kernel a ply).

A recurrent or frame-stacked checkpoint threads its state across the
agent's decisions, reset each episode.  The agent samples its masked
policy from a ``torch.Generator`` seeded with ``--seed``, or with
``--deterministic`` plays its most probable legal move.  ``--live-html``
rewrites a self-refreshing HTML board view after every move
(``utils/render.save_live_html``), ``--move-delay`` paces it.  The net
runs on ``--device`` (default ``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.enjoy \
        --load data/selfplay/ppo_wide2_4k.msgpack
    python -m gymothelloenv_tpu_torch.cli.enjoy --load ... --opponent human
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.compat import (GreedyPolicy, HumanPolicy,
                                            MaxiMinPolicy, RandomPolicy,
                                            SimpleOthelloEnv)
from gymothelloenv_tpu_torch.compat.featurize import make_state4
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.train.ppo_trainer import load_eval_policy
from gymothelloenv_tpu_torch.utils.device import resolve_device
from gymothelloenv_tpu_torch.utils.render import save_live_html


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.cli.enjoy")
    parser.add_argument("--load", type=str, required=True,
                        help="PolicyNet checkpoint (msgpack or .pth)")
    parser.add_argument("--opponent", type=str, default="greedy",
                        choices=["rand", "greedy", "maximin", "human"])
    parser.add_argument("--opponent-search-depth", type=int, default=2)
    parser.add_argument("--board-size", type=int, default=8)
    parser.add_argument("--episodes", type=int, default=1)
    parser.add_argument("--agent-plays-white", action="store_true")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--live-html", type=str, default="",
                        help="write a self-refreshing HTML board view to "
                             "this path after every move (open it in a "
                             "browser)")
    parser.add_argument("--move-delay", type=float, default=0.0,
                        help="seconds to sleep between moves (watchable "
                             "pacing for --live-html)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the net and the game")
    return parser


def main(argv=None) -> list:
    """Plays ``--episodes`` episodes; returns the agent's rewards."""
    args, _ = build_parser().parse_known_args(argv)
    device = resolve_device(args.device)
    cfg = EnvConfig(board_size=args.board_size)
    policy, desc = load_eval_policy(args.load, cfg, device=device)
    print(f"loaded {args.load} ({desc})")
    recurrent = getattr(policy, "recurrent", False)
    if recurrent:
        # Thread the state across the agent's decisions (reset each
        # episode), as the training collector does.
        h_state = torch.zeros(1, policy.hidden_size, device=device)

    if args.opponent == "rand":
        opp = RandomPolicy(seed=args.seed)
    elif args.opponent == "greedy":
        opp = GreedyPolicy()
    elif args.opponent == "maximin":
        opp = MaxiMinPolicy(args.opponent_search_depth)
    else:
        opp = HumanPolicy(args.board_size)

    env = SimpleOthelloEnv(board_size=args.board_size, seed=args.seed,
                           device=device)
    agent_color = 1 if args.agent_plays_white else -1
    generator = torch.Generator(device).manual_seed(args.seed)
    log: list = []

    def render_live(done=False, final=False, extra=""):
        # ``done`` shows the episode's game-over page; only ``final``
        # (the last episode) drops the refresh tag so the browser stops
        # polling: an episode-end page mid-run keeps refreshing, or the
        # later episodes would play unseen.
        if not args.live_html:
            return
        lines = ([extra] if extra else []) + log[-12:][::-1]
        save_live_html(args.live_html, env.env.board_state,
                       env.possible_moves if not done else (),
                       env.player_turn, lines, done=done,
                       keep_refreshing=not final)
        if args.move_delay:
            time.sleep(args.move_delay)

    if args.live_html:
        print(f"live board view: open {args.live_html} in a browser")

    rewards = []
    for ep in range(args.episodes):
        env.reset()
        opp.reset(env)
        done = False
        if recurrent:
            h_state = torch.zeros_like(h_state)
        render_live()
        while not done:
            env.render(mode="np_array")
            if env.player_turn == agent_color:
                obs = torch.as_tensor(make_state4(env), dtype=torch.float32,
                                      device=device)[None]
                with torch.inference_mode():
                    if recurrent:
                        logits, _, h_state = policy(
                            obs, h_state, torch.ones(1, device=device))
                    else:
                        logits, _ = policy(obs)
                mask = np.zeros(cfg.num_actions, bool)
                mask[env.possible_moves] = True
                dist = MaskedCategorical(
                    logits=logits, mask=torch.from_numpy(mask)[None].to(
                        device))
                if args.deterministic:
                    action = int(dist.mode()[0])
                else:
                    action = int(dist.sample(generator=generator)[0])
                print(f"agent plays {action}")
            else:
                action = int(opp.get_action(env.env.get_observation()))
                print(f"{args.opponent} plays {action}")
            mover = ("agent" if env.player_turn == agent_color
                     else args.opponent)
            _, reward, done, _ = env.step(action)
            log.append(f"{mover} plays {action}")
            # Never final here: the reward caption comes with the call
            # after the loop, and a page that stopped refreshing during
            # --move-delay would never show it.
            render_live(done=done)
        env.render(mode="np_array")
        outcome = reward if env.player_turn == agent_color else -reward
        print(f"episode {ep + 1}: agent reward {outcome}")
        render_live(done=True, final=ep == args.episodes - 1,
                    extra=f"episode {ep + 1}: agent reward {outcome}")
        rewards.append(outcome)
    return rewards


if __name__ == "__main__":
    main()
