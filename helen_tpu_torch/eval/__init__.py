from helen_tpu_torch.eval.debug import dump_mismatches, render_feature_column

__all__ = ["dump_mismatches", "render_feature_column"]
