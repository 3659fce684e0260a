from qavit_tpu_torch.interpret.gradcam import (grad_cam, gradcam_on_batch,
                                               save_gradcam_overlay)
from qavit_tpu_torch.interpret.rollout import attention_rollout

__all__ = ["grad_cam", "gradcam_on_batch", "save_gradcam_overlay",
           "attention_rollout"]
