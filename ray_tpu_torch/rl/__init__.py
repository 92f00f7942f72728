"""ray_tpu_torch.rl: reinforcement learning, the port of ``ray_tpu.rl``
(reference: rllib core loop).

Algorithms follow rllib's ``AlgorithmConfig.build() -> Algorithm.train()``
shape (algorithms/algorithm.py:212): PPO (sync on-policy), DQN (replay +
target nets, PER, double-Q), IMPALA and APPO (async sampling + aggregator
actors + V-trace), SAC, BC and MARWIL (offline), and multi-agent PPO.
Learners run on the card (``device="cpu"`` in a config keeps them on the
CPU); env runners are actors of the port's runtime that step the port's
own numpy environments (``envs.py``) and sample on the CPU.
"""

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.appo import APPO, APPOConfig
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.multi_agent import (
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    RendezvousEnv,
    register_multi_agent_env,
)
from ray_tpu_torch.rl.offline import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rl.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rl.sac import SAC, SACConfig
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer

__all__ = [
    "SAC",
    "SACConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "Algorithm", "AlgorithmConfig",
    "PPO", "PPOConfig", "PPOLearner",
    "DQN", "DQNConfig",
    "IMPALA", "IMPALAConfig",
    "APPO", "APPOConfig",
    "MultiAgentEnv", "MultiAgentPPO", "MultiAgentPPOConfig",
    "RendezvousEnv", "register_multi_agent_env",
    "ReplayBuffer", "PrioritizedReplayBuffer",
]
