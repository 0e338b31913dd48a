"""Object symmetry detection from two annotated views: the port of
rain_tpu/tools/vlm/image_symmetry.py.

A folder with exactly two views (front + right, axis-annotated) → GPT-4o
symmetry judgement, saved to <output_folder>/symmetry_analysis_result.txt.
Host only (no tensor, no ``--device``):

  python -m rain_tpu_torch.tools.vlm.image_symmetry --input_folder IN \\
      --output_folder OUT --api_key KEY
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from rain_tpu_torch.tools.vlm.common import ask_with_images, make_client

SYS_PROMPT = ("Mention if the image is symmetric. I am giving you two "
              "views of the same object: a front-facing view and a "
              "right-facing view, with some axes and angles marked. Tell "
              "if the object is symmetric or not (Symmetry means that the "
              "image is EXACTLY SAME ON BOTH SIDE OF AXES). If it is "
              "symmetric, return the axis of symmetry (along an angle if "
              "any) with respect to the original front-facing image.")

EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--api_key", required=True)
    args = p.parse_args(argv)

    files = [f for f in os.listdir(args.input_folder)
             if f.lower().endswith(EXTS)]
    if len(files) != 2:
        print(f"Error: Expected 2 images in the input folder, but found "
              f"{len(files)}.")
        return
    paths = [os.path.join(args.input_folder, f) for f in files]

    client = make_client(args.api_key)
    try:
        result = ask_with_images(client, "", paths, system=SYS_PROMPT,
                                 max_tokens=300)
    except Exception as e:
        result = f"An error occurred: {str(e)}"

    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    (out / "symmetry_analysis_result.txt").write_text(result)
    print(f"Processed: {files[0]} and {files[1]}")
    print(f"Result: {result}")


if __name__ == "__main__":
    main()
