from mvlpt_torch.prompts.learner import (
    PromptConsts,
    PromptSpec,
    build_prompt_consts,
    compute_cut_context_length,
    format_prompts,
    init_prompt_params,
    spec_from_cfg,
)
from mvlpt_torch.prompts.assembly import (
    cocoop_assemble,
    cocoop_condition,
    coop_assemble,
    upt_couple,
    vpt_prepare,
)
