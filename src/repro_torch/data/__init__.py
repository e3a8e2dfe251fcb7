from repro_torch.data.pipeline import DataPipeline, synth_batch

__all__ = ["DataPipeline", "synth_batch"]
