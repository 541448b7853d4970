"""ImageProcessingPipeline: vision-model transcription of submitted images.

Copy of ``archi_tpu/pipelines/image_processing.py``.

Mirrors the reference's ``ImageProcessingPipeline``
(``src/archi/pipelines/classic_pipelines/image_processing.py:16``): a vision
model transcribes images (text + LaTeX math) for downstream grading.
"""

from __future__ import annotations

import base64

from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.pipelines.base import BasePipeline
from archi_tpu_torch.utils.messages import Message


class ImageProcessingPipeline(BasePipeline):
    DEFAULT_MODEL_KEYS = {"image_model": "local/echo"}
    PROMPT_KEYS = {"image_prompt": []}

    def invoke(self, **kwargs) -> PipelineOutput:
        images: list[bytes] = kwargs.get("images", [])
        transcriptions = []
        prompt = self.prompts["image_prompt"].format()
        for img in images:
            b64 = base64.b64encode(img).decode()
            # OpenAI-style multimodal content; providers that don't support
            # it will raise and the caller surfaces the error.
            msg = Message(
                role="user",
                content=prompt,
                metadata={"images_b64": [b64]},
            )
            reply = self.llms["image_model"].invoke([msg])
            transcriptions.append(reply.content)
        return PipelineOutput(
            answer="\n\n".join(transcriptions),
            metadata={
                "num_images": len(images),
                "pipeline_used": self.__class__.__name__,
            },
        )
