from mvlpt_torch.data.elevater.manifest import (
    ELEVATER_20_TASKS,
    class_map,
    class_map_metric,
    first_classname,
    load_metadata,
    load_multitask_manifest,
    load_task_manifest,
    sample_few_shot_subset,
    template_map,
    train_val_split,
    write_task_manifest,
)
