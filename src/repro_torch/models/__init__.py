"""The LM template's model zoo in PyTorch.

A port of the JAX package's ``repro.models``: parameters are declared once
with their shapes and mesh axes (``common.ParamDef``);
``transformer.DecoderModel`` (the dense, moe, hybrid, ssm and vlm
families) and ``whisper.EncDecModel`` (audio) are ``nn.Module``s over
them in the reference's layouts, and ``lm`` builds the serving steps.
"""
