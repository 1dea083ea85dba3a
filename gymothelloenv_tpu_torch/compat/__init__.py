from gymothelloenv_tpu_torch.compat.envs import (  # noqa: F401
    BLACK_DISK,
    NO_DISK,
    WHITE_DISK,
    OthelloBaseEnv,
    OthelloEnv,
    SimpleOthelloEnv,
)
from gymothelloenv_tpu_torch.compat.policies import (  # noqa: F401
    GreedyPolicy,
    HumanPolicy,
    MaxiMinPolicy,
    RandomPolicy,
)
from gymothelloenv_tpu_torch.compat.torch_import import (  # noqa: F401
    import_actor_critic,
    import_dqn_net,
    import_dueling_dqn_net,
    import_policy_net,
    load_torch_checkpoint,
)
