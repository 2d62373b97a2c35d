from repro_torch.checkpoint.store import (save, save_async, wait_pending,
                                          latest_step, restore,
                                          PLAN_ARTIFACT, save_plan_artifact,
                                          load_plan_artifact,
                                          has_plan_artifact,
                                          plan_artifact_path)

__all__ = ["save", "save_async", "wait_pending", "latest_step", "restore",
           "PLAN_ARTIFACT", "save_plan_artifact", "load_plan_artifact",
           "has_plan_artifact", "plan_artifact_path"]
