"""Single-env evaluation driver — the port of ``cli/run.py`` (the
reference's run.py).

Plays ``--num-rounds`` games of protagonist vs opponent through the
embedded-opponent ``OthelloEnv`` (``compat/``), with a random colour
switch a round from the global ``np.random`` and win/draw/loss
bookkeeping (with the disk-count decoding of ``--num-disk-as-reward``,
run.py:100-122).  Every JAX flag plus ``--device`` (the env's, the
policies' and the agents'; default ``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.run --protagonist greedy \
        --opponent rand
    python -m gymothelloenv_tpu_torch.cli.run --protagonist maximin \
        --protagonist-search-depth 2 --opponent greedy --no-render \
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from gymothelloenv_tpu_torch.compat import (GreedyPolicy, HumanPolicy,
                                            MaxiMinPolicy, OthelloEnv,
                                            RandomPolicy)
from gymothelloenv_tpu_torch.compat.agents import DQNAgent, PPO, Rainbow
from gymothelloenv_tpu_torch.compat.featurize import make_state3, make_state4


def create_policy(policy_type="rand", board_size=8, seed=0,
                  search_depth=1, agent_name="", load_path="", device=None):
    """run.py:11-25 / util.py:28-45 — with the run.py DQN-class bug fixed
    (the reference instantiates the bare ``DQN`` nn.Module instead of
    ``DQNAgent``, run.py:21; SURVEY.md §3.1).  The learned agents live on
    ``device``."""
    if policy_type == "rand":
        policy = RandomPolicy(seed=seed)
    elif policy_type == "greedy":
        policy = GreedyPolicy()
    elif policy_type == "maximin":
        policy = MaxiMinPolicy(search_depth)
    elif policy_type == "human":
        policy = HumanPolicy(board_size)
    elif policy_type == "dqn":
        policy = DQNAgent(agent_name or "dqn", board_size, device=device)
    elif policy_type == "ppo":
        policy = PPO(agent_name or "ppo", board_size, device=device)
    elif policy_type == "rainbow":
        policy = Rainbow(agent_name or "rainbow", board_size, device=device)
    else:
        raise ValueError(f"unknown policy type: {policy_type!r}")
    if load_path and hasattr(policy, "load"):
        policy.load(load_path)
    return policy


def play(protagonist, protagonist_agent_type="greedy",
         opponent_agent_type="rand", board_size=8, num_rounds=100,
         protagonist_search_depth=1, opponent_search_depth=1, rand_seed=0,
         env_init_rand_steps=0, num_disk_as_reward=False, render=True,
         protagonist_load="", opponent_load="", device=None):
    print("protagonist: {}".format(protagonist_agent_type))
    print("opponent: {}".format(opponent_agent_type))

    protagonist_policy = create_policy(
        protagonist_agent_type, board_size, rand_seed,
        protagonist_search_depth, load_path=protagonist_load,
        device=device)
    opponent_policy = create_policy(
        opponent_agent_type, board_size, rand_seed,
        opponent_search_depth, load_path=opponent_load, device=device)

    # Scripted policies have no learning hook (run.py:93 calls .run on
    # every policy — a reference crash for scripted protagonists; we no-op).
    for p in (protagonist_policy, opponent_policy):
        if not hasattr(p, "run"):
            p.run = lambda *args: None

    if protagonist == 1:
        white_policy, black_policy = protagonist_policy, opponent_policy
    else:
        white_policy, black_policy = opponent_policy, protagonist_policy

    render_in_step = opponent_agent_type == "human" and render
    env = OthelloEnv(white_policy=white_policy, black_policy=black_policy,
                     protagonist=protagonist, board_size=board_size,
                     seed=rand_seed,
                     initial_rand_steps=env_init_rand_steps,
                     num_disk_as_reward=num_disk_as_reward,
                     render_in_step=render_in_step,
                     mute=not render, device=device)

    win_cnts = draw_cnts = lose_cnts = 0
    for i in range(num_rounds):
        if np.random.randint(2):
            protagonist = protagonist * -1
            env.switch_color()
        print("Episode {}".format(i + 1))
        print("Protagonist is {}".format(
            "BLACK" if protagonist == -1 else "WHITE"))

        # Learned agents take plane features; scripted ones read the env
        # handle (the reference passes raw boards to everyone, which
        # crashes its greedy/dqn/ppo protagonists — run.py:84-94 defect,
        # SURVEY.md §3.1; fixed here).
        def policy_obs(raw_obs):
            if isinstance(protagonist_policy, PPO):
                return make_state4(env)
            if isinstance(protagonist_policy, DQNAgent):
                return make_state3(env)
            return raw_obs

        obs = policy_obs(env.reset() * protagonist)
        protagonist_policy.reset(env)
        if render:
            env.render()
        done = False
        while not done:
            action = protagonist_policy.get_action(obs)
            next_obs, reward, done, _ = env.step(action)
            next_obs = policy_obs(next_obs * protagonist)
            protagonist_policy.run(obs, action, reward, done, next_obs)
            obs = next_obs
            if render:
                env.render()
        print("reward={}".format(reward))
        if num_disk_as_reward:
            total = board_size ** 2
            mine = (total + reward) / 2
            theirs = total - mine
            if mine > theirs:
                win_cnts += 1
            elif mine == theirs:
                draw_cnts += 1
            else:
                lose_cnts += 1
        else:
            if reward == 1:
                win_cnts += 1
            elif reward == 0:
                draw_cnts += 1
            else:
                lose_cnts += 1
        print("#Wins: {}, #Draws: {}, #Loses: {}".format(
            win_cnts, draw_cnts, lose_cnts))
    env.close()
    return win_cnts, draw_cnts, lose_cnts


def main(argv=None):
    parser = argparse.ArgumentParser()
    choices = ["rand", "greedy", "maximin", "human", "dqn", "ppo",
               "rainbow"]
    parser.add_argument("--protagonist", default="rand", choices=choices)
    parser.add_argument("--opponent", default="rand", choices=choices)
    parser.add_argument("--protagonist-plays-white", default=False,
                        action="store_true")
    parser.add_argument("--num-disk-as-reward", default=False,
                        action="store_true")
    parser.add_argument("--board-size", default=8, type=int)
    parser.add_argument("--protagonist-search-depth", default=1, type=int)
    parser.add_argument("--opponent-search-depth", default=1, type=int)
    parser.add_argument("--rand-seed", default=0, type=int)
    parser.add_argument("--num-rounds", default=100, type=int)
    parser.add_argument("--init-rand-steps", default=10, type=int)
    parser.add_argument("--no-render", default=False, action="store_true")
    parser.add_argument("--protagonist-load", default="", type=str)
    parser.add_argument("--opponent-load", default="", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of the env, the scripted "
                             "policies and the agents (cuda or cpu)")
    args, _ = parser.parse_known_args(argv)

    return play(protagonist=1 if args.protagonist_plays_white else -1,
                protagonist_agent_type=args.protagonist,
                opponent_agent_type=args.opponent,
                board_size=args.board_size,
                num_rounds=args.num_rounds,
                protagonist_search_depth=args.protagonist_search_depth,
                opponent_search_depth=args.opponent_search_depth,
                rand_seed=args.rand_seed,
                env_init_rand_steps=args.init_rand_steps,
                num_disk_as_reward=args.num_disk_as_reward,
                render=not args.no_render,
                protagonist_load=args.protagonist_load,
                opponent_load=args.opponent_load, device=args.device)


if __name__ == "__main__":
    main()
