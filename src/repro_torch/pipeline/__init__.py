"""The pipeline API of the port: specs, the prepare half, the inference
step, the stacked executor and the ``Pipeline`` factory."""
from repro_torch.data.spec import DataSpec
from repro_torch.pipeline.pipeline import Pipeline
from repro_torch.pipeline.specs import PipelineSpec, PlanSpec, SamplerSpec

__all__ = ["DataSpec", "Pipeline", "PipelineSpec", "PlanSpec",
           "SamplerSpec"]
