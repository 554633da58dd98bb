"""qasr_torch — the qasr quaternion-CNN speech recognizer in PyTorch, for
NVIDIA Hopper GPUs.

A port of the JAX package ``qasr`` (which stays the reference): the same
models, parameter names and shapes, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels built for ``sm_90a`` at first use. It imports
``torch`` and never JAX, and nothing of ``qasr``: it keeps its own copies of
the framework-free pieces (configs, TIMIT tables, batching, the native C++
decoder and scorer).

The symbols below are re-exported lazily, so ``import qasr_torch`` costs
nothing until one is touched.
"""

__version__ = "0.1.0"

# name -> submodule that defines it
_API = {
    # layers / models
    "QConv": "qasr_torch.models.layers",
    "QDense": "qasr_torch.models.layers",
    "QBatchNorm": "qasr_torch.models.layers",
    "PReLU": "qasr_torch.models.layers",
    "Dropout": "qasr_torch.models.layers",
    "QCNNEncoder": "qasr_torch.models.qcnn",
    "RealCNNEncoder": "qasr_torch.models.qcnn",
    "QBiLSTM": "qasr_torch.models.qlstm",
    "QLSTMLayer": "qasr_torch.models.qlstm",
    "QLSTMEncoder": "qasr_torch.models.qlstm",
    "RealBiLSTM": "qasr_torch.models.qlstm",
    "RealLSTMEncoder": "qasr_torch.models.qlstm",
    "build_model": "qasr_torch.models",
    # functional ops
    "qconv": "qasr_torch.ops.qlinalg",
    "qconv_fast10": "qasr_torch.ops.qlinalg",
    "qdense": "qasr_torch.ops.qlinalg",
    "qdense_fast8": "qasr_torch.ops.qlinalg",
    "qconv_fast8_stacked": "qasr_torch.ops.kernels.qconv_ft",
    "qconv_fast10_stacked": "qasr_torch.ops.kernels.qconv_ft",
    "tf_packed_to_stacked": "qasr_torch.models.layers",
    "stacked_to_tf_packed": "qasr_torch.models.layers",
    "hamilton_product": "qasr_torch.ops.quaternion",
    "quaternion_init": "qasr_torch.ops.initializers",
    "qconv_ft8": "qasr_torch.ops.kernels.qconv_ft",
    "qconv_ft10": "qasr_torch.ops.kernels.qconv_ft",
    "chain_layer": "qasr_torch.ops.kernels.qconv_chain",
    "qconv_dx8": "qasr_torch.ops.kernels.qconv_dx",
    "ChainLayerFn": "qasr_torch.ops.kernels.qconv_chain",
    "qgemm8_cl": "qasr_torch.ops.kernels.qgemm8",
    "QGemm8Fn": "qasr_torch.ops.kernels.qgemm8",
    "qdense_pallas8": "qasr_torch.ops.kernels.qgemm8",
    "qlstm_scan_fast8": "qasr_torch.ops.kernels.qlstm_scan",
    # decode / features / inference
    "ctc_greedy_decode": "qasr_torch.ops.ctc",
    "ctc_beam_search_decode": "qasr_torch.decode.beam",
    "ctc_loss": "qasr_torch.ops.ctc",
    "batch_per": "qasr_torch.decode.scoring",
    "featurize_waveform": "qasr_torch.features.frontend",
    "Transcriber": "qasr_torch.infer",
    # configs / training
    "Config": "qasr_torch.configs",
    "get_config": "qasr_torch.configs",
    "create_train_state": "qasr_torch.train.state",
    "train_step": "qasr_torch.train.step",
    "train": "qasr_torch.train.loop",
    "evaluate": "qasr_torch.train.loop",
    # parallelism
    "make_mesh": "qasr_torch.parallel.mesh",
    "ctc_loss_seq_parallel": "qasr_torch.parallel.seq_parallel",
    "qconv2d_seq_parallel": "qasr_torch.parallel.seq_parallel",
    # weights
    "params_from_jax": "qasr_torch.bridge",
    "save_params_npz": "qasr_torch.bridge",
    "load_params_npz": "qasr_torch.bridge",
    "params_to_jax": "qasr_torch.bridge",
}

__all__ = ["__version__", *sorted(_API)]


def __getattr__(name: str):
    target = _API.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target), name)
    globals()[name] = value  # cache for next access
    return value


def __dir__():
    return __all__
