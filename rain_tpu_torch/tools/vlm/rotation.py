"""Few-shot orientation classification with arrow reference images: the
port of rain_tpu/tools/vlm/rotation.py.

Four exemplar images of a chair facing right/forwards/left/backwards
(with colored direction arrows) plus the query image; GPT-4o names the
facing direction. Host only (no tensor, no ``--device``):

  python -m rain_tpu_torch.tools.vlm.rotation --api_key KEY \\
      --input_image Q [--exemplars R F L B]
"""

from __future__ import annotations

import argparse

from rain_tpu_torch.tools.vlm.common import ask_with_images, make_client

DEFAULT_EXEMPLARS = ["vlm/for_vlm_arrows/0001.png",
                     "vlm/for_vlm_arrows/0031.png",
                     "vlm/for_vlm_arrows/0061.png",
                     "vlm/for_vlm_arrows/0091.png"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--api_key", required=True)
    p.add_argument("--input_image", required=True)
    p.add_argument("--exemplars", nargs=4, default=DEFAULT_EXEMPLARS,
                   help="right/forwards/left/backwards reference images")
    args = p.parse_args(argv)

    e = args.exemplars
    question = f"""{e[0]} is a chair facing right. {e[1]} is a chair facing forwards. {e[2]} is a chair facing the left. {e[3]} is a chair facing backwards.

The yellow arrow represents left, red represents backwards, green represents right, blue represents forwards.

Identify which arrow is pointing in the same direction that the chair in {args.input_image} is facing. Is the chair in {args.input_image} facing right, forwards, left, or backwards?"""

    client = make_client(args.api_key)
    prompt = (f"Here are five images: {', '.join(e)}, "
              f"{args.input_image}. {question}")
    print(ask_with_images(client, prompt, e + [args.input_image]))


if __name__ == "__main__":
    main()
