from mvlpt_torch.config.config import CfgNode, dump_yaml, load_yaml
from mvlpt_torch.config.defaults import get_cfg_default, optim_config, validate_support
