"""Two-agent training driver — the port of ``cli/run_2agent.py`` (the
reference's run_2agent.py).

Both colors are driven explicitly by the caller (SimpleOthelloEnv, no
embedded opponent); each color's agent learns from its own decisions with
cross rewards: a color's transition is completed when it is next to move
(or at termination), its reward the negation of the opponent's last
mover-perspective reward (run_2agent.py:118-160).

This is the faithful single-env host loop; the batched equivalent is
``train/dqn_trainer.py`` / ``train/ppo_trainer.py``.  Every JAX flag plus
``--device`` (the env's, the policies' and the agents'; default
``cuda``).

Usage:
    python -m gymothelloenv_tpu_torch.cli.run_2agent --protagonist dqn \
        --opponent rand --num-rounds 1000
"""

from __future__ import annotations

import argparse

import numpy as np

from gymothelloenv_tpu_torch.cli.run import create_policy
from gymothelloenv_tpu_torch.compat import SimpleOthelloEnv
from gymothelloenv_tpu_torch.compat.agents import PPO
from gymothelloenv_tpu_torch.compat.featurize import make_state3, make_state4


def _featurize_for(policy, env):
    if isinstance(policy, PPO):
        return make_state4(env)
    return make_state3(env)   # DQN + scripted (scripted ignore obs)


def play(protagonist, protagonist_agent_type="greedy",
         opponent_agent_type="rand", board_size=8, num_rounds=100,
         protagonist_search_depth=1, opponent_search_depth=1,
         rand_seed=0, env_init_rand_steps=0, num_disk_as_reward=False,
         render=False, protagonist_load="", opponent_load="", device=None):
    protagonist_policy = create_policy(
        protagonist_agent_type, board_size, rand_seed,
        protagonist_search_depth, load_path=protagonist_load,
        device=device)
    opponent_policy = create_policy(
        opponent_agent_type, board_size, rand_seed,
        opponent_search_depth, load_path=opponent_load, device=device)

    def nop(*args):
        pass
    opponent_policy.run = nop          # run_2agent.py:74-77
    if not hasattr(protagonist_policy, "run"):
        protagonist_policy.run = nop

    env = SimpleOthelloEnv(
        board_size=board_size, seed=rand_seed,
        initial_rand_steps=env_init_rand_steps,
        num_disk_as_reward=num_disk_as_reward, render_in_step=render,
        mute=not render, device=device)

    win = draw = lose = 0
    for i in range(num_rounds):
        if np.random.randint(2):
            protagonist = protagonist * -1
        policy = ({"black": protagonist_policy, "white": opponent_policy}
                  if protagonist == -1 else
                  {"black": opponent_policy, "white": protagonist_policy})
        print("Episode {}: protagonist is {}".format(
            i + 1, "BLACK" if protagonist == -1 else "WHITE"))

        env.reset()
        for p in (protagonist_policy, opponent_policy):
            p.reset(env)
        state_b = _featurize_for(policy["black"], env)
        done_b = done_w = False
        init = True
        state_w = action_w = None
        reward_b = reward_w = 0.0
        while not (done_b or done_w):
            assert env.player_turn == -1
            action_b = policy["black"].get_action(state_b)
            _, reward_b, done_b, _ = env.step(action_b)
            next_state_b = _featurize_for(policy["black"], env)
            while (not done_b) and env.player_turn == -1:
                policy["black"].run(state_b, action_b, reward_b, done_b,
                                    next_state_b)
                state_b = next_state_b
                action_b = policy["black"].get_action(state_b)
                _, reward_b, done_b, _ = env.step(action_b)
                next_state_b = _featurize_for(policy["black"], env)

            if not init:
                policy["white"].run(state_w, action_w, -reward_b, done_b,
                                    next_state_b)
            init = False
            if done_b:
                policy["black"].run(state_b, action_b, reward_b, done_b,
                                    next_state_b)
                break

            assert env.player_turn == 1
            state_w = next_state_b
            action_w = policy["white"].get_action(state_w)
            _, reward_w, done_w, _ = env.step(action_w)
            next_state_w = _featurize_for(policy["white"], env)
            while (not done_w) and env.player_turn == 1:
                policy["white"].run(state_w, action_w, reward_w, done_w,
                                    next_state_w)
                state_w = next_state_w
                action_w = policy["white"].get_action(state_w)
                _, reward_w, done_w, _ = env.step(action_w)
                next_state_w = _featurize_for(policy["white"], env)

            policy["black"].run(state_b, action_b, -reward_w, done_w,
                                next_state_w)
            if done_w:
                policy["white"].run(state_w, action_w, reward_w, done_w,
                                    next_state_w)
                break
            state_b = next_state_w

        reward = reward_w * protagonist if done_w \
            else reward_b * -protagonist
        if num_disk_as_reward:
            total = board_size ** 2
            mine = (total + reward) / 2
            theirs = total - mine
            win, draw, lose = (win + (mine > theirs),
                               draw + (mine == theirs),
                               lose + (mine < theirs))
        else:
            win, draw, lose = (win + (reward == 1), draw + (reward == 0),
                               lose + (reward == -1))
        print("#Wins: {}, #Draws: {}, #Loses: {}".format(win, draw, lose))
    return win, draw, lose


def main(argv=None):
    parser = argparse.ArgumentParser()
    choices = ["rand", "greedy", "maximin", "human", "dqn", "ppo",
               "rainbow"]
    parser.add_argument("--protagonist", default="dqn", choices=choices)
    parser.add_argument("--opponent", default="rand", choices=choices)
    parser.add_argument("--protagonist-plays-white", action="store_true")
    parser.add_argument("--num-disk-as-reward", action="store_true")
    parser.add_argument("--board-size", default=8, type=int)
    parser.add_argument("--protagonist-search-depth", default=1, type=int)
    parser.add_argument("--opponent-search-depth", default=1, type=int)
    parser.add_argument("--rand-seed", default=0, type=int)
    parser.add_argument("--num-rounds", default=100, type=int)
    parser.add_argument("--init-rand-steps", default=10, type=int)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--protagonist-load", default="", type=str)
    parser.add_argument("--opponent-load", default="", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of the env, the scripted "
                             "policies and the agents (cuda or cpu)")
    args, _ = parser.parse_known_args(argv)

    return play(protagonist=1 if args.protagonist_plays_white else -1,
                protagonist_agent_type=args.protagonist,
                opponent_agent_type=args.opponent,
                board_size=args.board_size, num_rounds=args.num_rounds,
                protagonist_search_depth=args.protagonist_search_depth,
                opponent_search_depth=args.opponent_search_depth,
                rand_seed=args.rand_seed,
                env_init_rand_steps=args.init_rand_steps,
                num_disk_as_reward=args.num_disk_as_reward, render=args.render,
                protagonist_load=args.protagonist_load,
                opponent_load=args.opponent_load, device=args.device)


if __name__ == "__main__":
    main()
