"""Checkpoint conversion CLI: torch/safetensors → streamed param dir.

Counterpart of ``icl_speech_text_llm_tpu/cli/convert.py`` (same flags, same
output dir, same last printed line), in numpy and torch alone:

  python -m icl_speech_text_llm_tpu_torch.cli.convert \\
      --src /path/to/vicuna-13b  --dst converted/vicuna-13b \\
      --model_type vicuna-13b --quantize_int4

``--src`` accepts an HF sharded-safetensors dir (model.safetensors.index.json),
a single .safetensors file, or a torch .pth/.bin. ``--component salmonn``
converts a salmonn_v1.pth adapter checkpoint (Q-Former + LoRA; small, no
streaming needed) via models/convert.convert_salmonn_checkpoint. Load the
results with ``cli/inference.py --llm_params_dir`` / ``--adapter_params_dir``.
"""

from __future__ import annotations

import argparse
import json
import logging

logger = logging.getLogger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description="Convert checkpoints to the port's param layout")
    p.add_argument("--src", required=True, help="checkpoint file or HF model dir")
    p.add_argument("--dst", required=True, help="output param dir")
    p.add_argument("--model_type", default="vicuna-13b",
                   help="decoder config name (models/llama.DECODER_CONFIGS)")
    p.add_argument("--component", default="decoder",
                   choices=["decoder", "salmonn"],
                   help="decoder: HF LLM weights (streamed); salmonn: "
                        "salmonn_v1.pth Q-Former/LoRA adapter")
    p.add_argument("--prefix", default="model.", help="HF key prefix to strip")
    p.add_argument("--qformer_config", default="auto",
                   help="Q-Former config name for --component salmonn "
                        "(models/qformer.QFORMER_CONFIGS; auto: by model_type)")
    p.add_argument("--quantize_int8", action="store_true",
                   help="store matmul weights as int8 {q,s} (serving layout)")
    p.add_argument("--quantize_int4", action="store_true",
                   help="store matmul weights as split-half packed group-128 "
                        "int4 {q4,s} (lm_head stays int8)")
    p.add_argument("--dtype", default="float32", choices=["float32", "float16"],
                   help="storage dtype for non-quantized float weights")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)

    if args.component == "salmonn":
        import numpy as np

        from ..models.convert import convert_salmonn_checkpoint, load_torch_state_dict
        from ..models.llama import DECODER_CONFIGS
        from ..models.qformer import QFORMER_CONFIGS
        from ..models.stream_convert import _DirWriter, flatten_tree

        sd = load_torch_state_dict(args.src)
        qf_name = (args.qformer_config if args.qformer_config != "auto"
                   else "salmonn" if "13b" in args.model_type else "salmonn-7b")
        qf = QFORMER_CONFIGS[qf_name]
        tree = convert_salmonn_checkpoint(sd, qf, DECODER_CONFIGS[args.model_type])
        writer = _DirWriter(args.dst)
        for tree_path, leaf in flatten_tree(tree).items():
            writer.put(tree_path, np.asarray(leaf))
        writer.close()
        logger.info("salmonn adapter converted → %s (%d tensors)",
                    args.dst, len(writer.manifest))
        print(json.dumps({"dst": args.dst, "tensors": len(writer.manifest)}))
        return

    from ..models.llama import DECODER_CONFIGS
    from ..models.stream_convert import TensorSource, stream_decoder_to_dir

    cfg = DECODER_CONFIGS[args.model_type]
    src = TensorSource(args.src)
    mode = "int4" if args.quantize_int4 else ("int8" if args.quantize_int8 else False)
    manifest = stream_decoder_to_dir(
        src, cfg, args.dst, prefix=args.prefix,
        quantize=mode, dtype=args.dtype,
    )
    logger.info("decoder converted → %s (%d tensors, quantize=%s)",
                args.dst, len(manifest), mode)
    print(json.dumps({"dst": args.dst, "tensors": len(manifest),
                      "quantized": mode}))


if __name__ == "__main__":
    main()
