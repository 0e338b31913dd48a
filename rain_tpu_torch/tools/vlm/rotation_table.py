"""Table axis-alignment classification with arrow reference images: the
port of rain_tpu/tools/vlm/rotation_table.py.

Three exemplars of tables aligned with the left-right (yellow) axis, one
with the up-down (green) axis, plus the query image; GPT-4o names the
alignment. Host only (no tensor, no ``--device``):

  python -m rain_tpu_torch.tools.vlm.rotation_table --api_key KEY \\
      --input_image Q [--exemplars A B C D]
"""

from __future__ import annotations

import argparse

from rain_tpu_torch.tools.vlm.common import ask_with_images, make_client

DEFAULT_EXEMPLARS = ["vlm/for_vlm_arrows_centroid/table2_0001.png",
                     "vlm/for_vlm_arrows_centroid/table2_0021.png",
                     "vlm/for_vlm_arrows_centroid/table2_0041.png",
                     "vlm/for_vlm_arrows_centroid/table2_0055.png"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--api_key", required=True)
    p.add_argument("--input_image", required=True)
    p.add_argument("--exemplars", nargs=4, default=DEFAULT_EXEMPLARS)
    args = p.parse_args(argv)

    e = args.exemplars
    question = f"""{e[0]}, {e[1]}, and {e[2]} are tables aligned with the yellow arrow, the left-right axis, as the tabletop is more in line with that axis. {e[3]} is a table aligned with the green arrow, the up-down axis, as the tabletop is more in line with that axis.

Identify which arrow and axis is the table in {args.input_image} aligned with."""

    client = make_client(args.api_key)
    prompt = (f"Here are five images: {', '.join(e)}, "
              f"{args.input_image}. {question}")
    print(ask_with_images(client, prompt, e + [args.input_image]))


if __name__ == "__main__":
    main()
