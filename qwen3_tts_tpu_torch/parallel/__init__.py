from .dryrun import dryrun_multichip
from .mesh import (make_mesh, shard_consts, shard_gen_state,
                   shard_talker_weights, talker_shardings,
                   unfuse_stack_layers)

__all__ = ["make_mesh", "unfuse_stack_layers", "talker_shardings",
           "shard_talker_weights", "shard_gen_state", "shard_consts",
           "dryrun_multichip"]
