"""Monocular depth for the depth-supervised configs, by a depth tool the
user names: the command template's {input} and {output} are the cached
image folder and the depth folder (grayscale 16-bit PNGs). MiDaS itself is
not bundled; the default template is its run.py.

    python -m log_tpu_torch.apps.calibration.run_midas --input <images> \
        --output <depth dir> [--cmd "<template>"]

The command runs in a shell; a non-zero exit raises.
"""
from __future__ import annotations

import argparse
import os
import subprocess


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="cached image dir")
    parser.add_argument("--output", required=True, help="depth output dir")
    parser.add_argument(
        "--cmd",
        default=(
            "python run.py --model_type dpt_beit_large_512 "
            "--input_path {input} --output_path {output} --grayscale"
        ),
        help="depth-tool command template with {input}/{output} slots",
    )
    args = parser.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    cmd = args.cmd.format(input=args.input, output=args.output)
    print(cmd)
    subprocess.run(cmd, shell=True, check=True)


if __name__ == "__main__":
    main()
