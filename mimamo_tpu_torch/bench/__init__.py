"""The port's probes: ``layer1_probe`` (how fast could a fused layer1 be on
the card?) and ``layer2_probe`` (the layer2 probe's variants and its
dots-only kernel), run as ``python -m mimamo_tpu_torch.bench.<probe>``;
``_timing`` holds their timing protocol and the card's label."""
