"""Ask GPT-4o which mask colors correspond to which object parts: the
port of rain_tpu/tools/vlm/parts.py.

Two images (a photo and its SAM mask visualization) → color↔part naming.
Host only (no tensor, no ``--device``):

  python -m rain_tpu_torch.tools.vlm.parts --api_key KEY --photo P \\
      --masks M
"""

from __future__ import annotations

import argparse

from rain_tpu_torch.tools.vlm.common import ask_with_images, make_client


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--api_key", required=True)
    p.add_argument("--photo", default="vlm/testdata/dresser.jpg")
    p.add_argument("--masks", default="vlm/testdata/masks.jpg")
    args = p.parse_args(argv)

    client = make_client(args.api_key)
    question = (f"Here are two images: {args.photo} and {args.masks}. "
                f"{args.photo} is a photo of an object, while {args.masks} "
                "visualises its SAM masks. Which colors correspond to "
                "which parts?")
    print(ask_with_images(client, question, [args.photo, args.masks]))


if __name__ == "__main__":
    main()
