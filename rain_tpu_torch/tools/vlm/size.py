"""Ask GPT-4o which object parts are equal in size: the port of
rain_tpu/tools/vlm/size.py. Host only (no tensor, no ``--device``):

  python -m rain_tpu_torch.tools.vlm.size --api_key KEY --image_path P
"""

from __future__ import annotations

import argparse

from rain_tpu_torch.tools.vlm.common import ask_with_images, make_client

SYS_PROMPT = ("Mention any objects in the image that are equal in size "
              "some of the example objects are given to you (not all). "
              "JUST MENTION THE OBJECT NAMES THAT ARE EQUAL IN SIZE AND "
              "NOTHING ELSE (For example for a table dresser with equal "
              "size of drawers and wheels, the output should look like, "
              "Assistant: Wheel,Drawer")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--api_key", required=True)
    p.add_argument("--image_path", required=True)
    args = p.parse_args(argv)

    client = make_client(args.api_key)
    try:
        answer = ask_with_images(client, "", [args.image_path],
                                 system=SYS_PROMPT, max_tokens=300)
        print("Assistant: " + answer)
    except Exception as e:  # matches reference error reporting
        print(f"An error occurred: {str(e)}")


if __name__ == "__main__":
    main()
