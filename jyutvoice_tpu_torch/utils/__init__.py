"""Training and inference utilities: mel / alignment images, the TensorBoard
logger, stage timers, parameter counts, traces and the NaN guard."""
