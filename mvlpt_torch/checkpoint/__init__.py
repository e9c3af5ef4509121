from mvlpt_torch.checkpoint.convert import (
    config_from_state_dict,
    convert_openai_rn_state_dict,
    convert_openai_state_dict,
    load_clip,
    rn_config_from_state_dict,
)
from mvlpt_torch.checkpoint.from_jax import backbone_from_jax, prompt_params_from_jax
from mvlpt_torch.checkpoint.prompt_io import (
    apply_state_dict,
    average_checkpoints,
    checkpoint_path,
    export_reference_checkpoint,
    find_checkpoint,
    flatten_params,
    list_epoch_checkpoints,
    load_prompt_checkpoint,
    save_prompt_checkpoint,
    unflatten_params,
)
